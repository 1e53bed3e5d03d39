#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fast_tffm_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each printing one JSON line; any failure exits non-zero before the
last line:

  device    the card's name and, as nvidia-smi reports them, name and power limit
  build     every CUDA kernel of the ported paths, built from csrc/ with nvcc
            (one nvcc per source, all started together); each kernel
            function's registers, spills and shared memory from -Xptxas=-v
  anova_fwd the ANOVA forward kernel against its plain PyTorch version on the
            card (rtol 1e-5, atol 1e-6) at the serving and training shapes
            and the quality zoo's fm3 batch (B 8,192, N 12, k 4), with each
            one's median time per call by CUDA events (ms), its device time
            from a torch.profiler trace (device_ms) and the least time the
            card could take (bound_ms)
  anova_bwd the ANOVA backward kernel against anova_inter_bwd_plain, the same
            way (rtol 1e-5, atol 1e-6), at B in {1, 512, 16384} x order in
            {3, 4}, a ragged shape, the criteo width N = 39 and the quality
            zoo's fm3 batch (B 8,192, N 12, k 4)
  fm2_score the order-2 FM score and L2 kernel pair (csrc/fm2_score.cu)
            against its plain twin (_FmScoreOrder2 + masked_l2 under
            autograd) on the card at the benchmark cells' batches (B 16,384,
            N 39, D 17; B 8,192, D 9) and a ragged one: scores and d_rows
            within 1e-5 of their largest magnitude, the L2 term within rtol
            1e-5; each kernel's events and device ms, its bound and the
            twin's ms (no single PyTorch call computes it)
  dcn_cross the DCN-V2 cross combine pair (csrc/dcn_cross.cu) against its
            plain twin on the card at the dcnv2 cell's layer (B 8,192,
            d 4,992) and ragged shapes (d 5 and 4,991): y, d_h and d_x0
            bitwise, the bias sum within 1e-5 of its largest magnitude;
            each kernel's events and device ms (the backward writing and
            adding into d_x0), its bound and the twin's ms
  data      tools/torch_gen_synthetic.py (tools/gen_synthetic.py's bytes)
            writes 24 x 16384 baseline5-shaped train
            rows (--seed 7), 2 x 16384 validation rows (--seed 8) and the
            config's 64 x 16384-row epoch (--seed 9), all three at once
  data_zoo  the same tool, the four files at once with the seeds of the
            configs' headers: 262,144 + 16,384 criteo-shaped libsvm rows
            (39 fields) and 131,072 + 16,384 avazu-shaped libffm rows (22
            fields, binary values)
  parse     the train file through the native C++ stream at the config's
            thread_num (8) and at 0 (every usable core), and through the
            Python stream: every batch bitwise equal; rows/s of each and the
            host's cores
  rows_tail the rows Adagrad kernel (B4: torch.sort, then one launch on the
            sorted ids) against optim.sparse_adagrad_update on clones of one
            full-width [2^20, 9] state with the first training batch's ids:
            element and row accumulators, decay 1 and 0.9, one id, 1001
            unique ids, and the hot id 0 of a 1000-row batch padded to
            16384; every case bitwise equal.  Times (tail_timings): the
            kernel alone on the sort's output (events; device time L2-warm
            and after a 64 MiB write), the update (sort + kernel), the
            kernel on deduped input, dedup_rows alone, dedup_rows + kernel,
            the hot-id update, the plain twin; bounds for M occurrences and
            for deduped input, and the M-occurrence bound in whole sectors;
            then the zoo's shapes, element and row accumulators at decay 1
            and 0.9, each bitwise: baseline1's first batch (N = 39, D = 9,
            M = 638,976) and baseline3's (N = 22, D = 89, M = 180,224), with
            the kernel's, the update's and the twin's times and the bound
  fused_tail the fused Adagrad kernel (B3) on a full-width fused state packed
            from a seeded [2^20, 9] table and [2^20, 1] accumulator, against
            its plain version on the card, bitwise, at decay 1 and 0.9 for
            the first batch's ids, one id, 1001 ids, the ids of the last,
            partial tile row (V-4 .. V-1) and the padded batch's hot id 0;
            untouched slots and pad lanes unchanged; unpacked, bitwise
            equal to the rows kernel in row mode on the logical clones; the
            same times as rows_tail
  train     configs/baseline5_fm_order3_kdd.cfg at full width trained for
            24 steps on cuda through training.train (resume from a seeded
            npz; text parsed natively, thread_num 8; the run traced by
            torch.profiler), then the same on the CPU:
            finite losses, every kernel of the path launched (B2 and the
            tail once per step), the final tables and accumulators within atol 1e-7,
            the updates within 1e-2 by relative norm and moving the same
            elements (to 1e-3), and the validation AUCs within 0.002 of
            each other; the order-3 gradient on the card
            against the CPU's; ex/s, the step time p50, and the card's idle
            share over the run and within one traced step
  train_fused the same run with table_layout = packed and adagrad_accumulator
            = fused (a [V, 1] accumulator in the npz): the fused kernel once
            per step, the card's unpacked table and accumulator within atol
            1e-7 of the CPU run's, the same update and AUC checks and timings
  predict   prediction.predict of the trained model on the validation file
            on cuda, its printed scores within 1e-6 of the CPU predict's
  predict_packed the same for the fused run's checkpoint under its packed
            config (scored through the packed gather)
  serve     the same config serving 4096 libsvm lines through serve_lines
            on cuda from a seeded 2^20 x 9 table; every score finite and
            within atol 1e-6 of the port's own CPU path, and the forward
            kernel launched on that path (then a second pass under
            torch.profiler: the card's busy and idle share of the serving
            wall time, and its top kernels); then the same lines served on
            cuda under table_layout = packed, within atol 1e-6 of the rows
            config's scores
  train_fm2, train_ffm, train_deepfm  configs/baseline1_fm_criteo_sample.cfg
            (order-2 FM), baseline3_ffm_avazu.cfg (FFM, rows 89 wide) and
            baseline4_deepfm_criteo.cfg (DeepFM, bf16 MLP operands) at full
            width through training.train on cuda and on the CPU from one
            seeded npz (16, 16 and 32 steps): B4 once per step and no other
            kernel; the FM and FFM runs held as the train phase holds
            baseline5; DeepFM's table and MLP updates within MLP_DRIFT_RTOL
            by relative norm and one step's gradients, card against CPU from
            the CPU's final state, within MLP_GRAD_RTOL; AUCs within 0.002;
            the step time with the input on the card, a traced step, and
            DeepFM's MLP route and its time (with aten::mm.dtype measured
            beside it)
  predict_<model>, serve_<model>  each trained zoo model: predict on cuda
            against the CPU, and 4096 validation lines (libffm with fields
            for FFM) served on cuda against the port's CPU path, within atol
            1e-6 (bf16 DeepFM: 1e-4); no kernel on these paths
  train_dcnv2, predict_dcnv2, serve_dcnv2  configs/torch/dcnv2_criteo1tb.cfg
            (DCN-V2 at MLPerf's widths: k 128, 3 cross layers of rank 512,
            MLP 1024-1024-512-256-1, bf16 operands, row accumulator) on the
            zoo's criteo-shaped data, its vocabulary cut to the data's 2^20
            rows: training.train on the card (32 steps), the cross pair
            three times a step each way (validation adds forwards), B4 once
            and no other kernel, finite losses and AUC; then, card against
            CPU from the trained checkpoint at float32 operands
            (DCNV2_CHECKED_DTYPE), one step's gradients on 1,024 validation
            rows (DCNV2_GRAD_RTOL) and predict and serve as the zoo's (ATOL),
            the pair's forward the only kernel serving
  train_cached_deepfm  baseline4 with device_cache and steps_per_call = 8:
            B4's 32 launches inside 4 CUDA-graph replays, the final state
            (MLP included) and AUC bitwise train_deepfm's eager card run;
            the graph's step time beside the eager cached step's
  train_fmb the train phase's checks with binary_cache and shuffle, 2 epochs
            (48 steps; the card's and the CPU's shuffled batches are the
            same); then a second card run that reuses the cache
  train_cached, train_cached_fused  device_cache, shuffle and
            steps_per_call = 8 for 2 epochs on the rows and the fused layout:
            every 8 steps one CUDA-graph replay.  The train phase's checks
            against the CPU (the replays' launches counted by kernel name
            in the run's profiler trace, less the wrappers' own: the
            capture's warm-up and validation), and bitwise against the
            card's own steps_per_call = 1 run from the same npz and cache;
            the graph's step time p50 beside the eager K = 1 step's, the
            device busy time per step of a traced replay and its idle share
  packed_tail kernel B4 at the packed address (P = 14 rows of 9 floats to a
            128-float tile row) on a full-width packed state, against its
            twin on the card and, unpacked, the rows kernel, bitwise: element
            and row accumulators, decay 1 and 0.9, the first batch, one id,
            the last partial tile row, the hot id 0; pad lanes and slots
            untouched; times and bounds at the first batch
  resume_streamed  rows, native text, 24 steps: the uninterrupted card run,
            one stopped by SIGTERM from its step hook at step 10 (its saved
            cursor checked) and its resume, bitwise the uninterrupted run;
            then cli train in a subprocess sent SIGTERM after its first
            logged window (exit 0) and cli train --resume, bitwise the
            in-process run of the same 2-epoch config
  resume_fmb_shuffled  binary_cache + shuffle, 2 epochs, stopped at step 31
            (epoch 1): the same checks
  resume_cached, resume_cached_fused  device_cache + shuffle +
            steps_per_call = 8, 2 epochs, stopped at the call that holds step
            20 (it ends at 24): bitwise, and no capture beyond the one an
            uninterrupted run makes
  convert   cli convert on a config whose files have no caches: each packed;
            then a binary_cache card run that rebuilds none
  train_packed_element, train_packed_row  table_layout = packed with an
            element or row accumulator, 24 steps: the train phase's checks
            against the CPU, and bitwise the card's rows run with the same
            accumulator
  train_dedup  dedup_gather_rows = 180,224 at K = 1 and K = 8 (streamed, a
            CUDA graph; the port gathers directly and checks the cap):
            bitwise the resume_streamed phase's plain run; a cap of 16,384
            fails before any batch ships
  telemetry_train  the train phase's config and npz with metrics_path,
            profile_steps 8:12, datastats every 4 steps, the watchdog (60 s)
            and memory every 0.5 s: every record's envelope and keys, no
            steady-state compile, the profile window's start/stop records and
            its trace against the wrappers' launches inside the window (one
            forward, backward and tail a step; the one loss below aside),
            the memory records above the state's bytes, the final state
            bitwise the train phase's; the loop's step p50 with and without
            telemetry (plain, instrumented, instrumented, plain)
  telemetry_cached the train_cached config with metrics_path: the capture a
            warm-up compile, train_step and train_graph_k8 profile records,
            bitwise the train_cached card run; its replays counted by kernel
            name in a trace of the run, as train_cached's
  telemetry_serve, telemetry_predict  the trained model served (2048 lines)
            and predicted with metrics_path: kind=serving / kind=predict with
            their keys, profile records per bucket and for predict_step
  ckpt_async the rows and the fused run (2 epochs) with async_save against
            the same run saved synchronously: bitwise equal files, kind=ckpt
            mode full and sync, each save's train_stall_ms
  ckpt_delta delta_every_steps = 8 at K = 1 (native text) and K = 8 (device
            cache): the chain to the run's end replays bitwise the
            uninterrupted run, a resume from the chain head at step 16 ends
            bitwise it, each delta's rows_written its window's unique ids
  ckpt_ffm  baseline3 (FFM, a 746 MB state, 16 steps) saved sync and async in
            turns: bitwise equal files, train_stall_ms and whole-run ex/s
            (every K = 8 run of these phases traced, as train_cached's)
  serve_reload hot reload at full width: a card run (2 epochs, delta every
            8 steps, async saves) stopped after its last step leaves base@24
            + deltas @32, @40, @48; an engine polling every 0.2 s serves the
            base while each delta, then a new full save (the fused run's),
            then a torn delta land one at a time: after each stage a 64-row
            probe bitwise a fresh card engine on the same chain head; the
            torn file counted and given up on (reload_max_retries 3); the
            counts (a tick racing the full save's chain reset may count a
            failure: chain_reset_failures, apart from the torn file's
            three), each stage's landed-to-scored ms and the freshness
            records; then a flush loop racing reload_once's apply of delta
            1 (every flush bitwise one head or the other) and the apply's
            and a full reload's stage times; then (``orbax``) an engine
            started from an orbax directory holding the fused run's state,
            and reloaded in full once the chain head's is saved over it:
            each state's scores bitwise a fresh card engine's, the save's
            and the reload's ms
  serve_socket python -m fast_tffm_tpu_torch.cli serve <cfg> --port 0 with
            [Serving] replicas = 2 on the card, serving the chain at delta 2:
            4096 lines over two affinity-pinned FrameConnections (64-row
            frames, pipelined) and over JSONL, every score within atol 1e-6
            of the in-process engine's (a coalesced flush scores at another
            bucket) and of serve_lines' printed one; lines/s and row latency
            p50/p99; each replica's stats (device cuda, B1 launches during
            the traffic)
  serve_failover the same stream with replica 0 SIGKILLed midway: every
            row answered, scores serve_socket's; the restart and its MTTR;
            delta 3 landed: one fan-out, staged_delta once per replica, each
            replica's probe bitwise serve_reload's head; a replica slowed
            200 ms x 4 under 50 ms row deadlines answers typed deadlines
  throughput the config's 1,048,576-row epoch on the card only, streamed
            through the native parser, from FMB (converted first, timed
            apart) as configured and on arrays, the same with
            steps_per_call = 8, and device-cached with steps_per_call = 8:
            logged and whole-run ex/s and the card's idle share of each run
  telemetry_cost the same streamed native epoch in turns plain, with the
            monitor (metrics_path, watchdog, memory, a profile window at
            steps 56:60) and with datastats every 4 steps as well, 8 rounds:
            each run's step gaps after step 4 to step 52 (p50 and mean), per
            mode the median of the runs, and per round its time relative to
            the round's plain run: whether all rounds agree in sign, and the
            smallest relative difference they resolve
  rollback  on_nan = rollback on FMB input, 2 epochs of 24 steps, a save
            each epoch, log_every 4, fault plan nan@30:31 (the host-side loss
            of step 30 poisoned): the log point at 32 raises with the cursor
            (epoch 1, batch 8), the step-24 save is restored into the live
            tensors and batches 8-23 of epoch 1 train (48 steps run, step 40
            at the end): bitwise the run that resumes that save at that
            cursor, within TABLE_ATOL of the CPU's same rollback; again on
            the device cache at K = 8 (nan@30:33) with one graph capture;
            max_rollbacks = 1 and a second window (nan@34:35) raises at 36.
            restore_ms (npz read and copy to the card) and rollback_wall_ms
            (from the failing call to the first call after the rollback)
  supervised cli train --supervised --resume on FMB input, a save every 4
            steps (a full save at 4, then deltas), plan kill@18,torn_delta@2,
            io_error@3: one crash record (SIGKILL), one restart record with
            mttr_s, the torn delta 2 quarantined, an io_retry record, the
            relaunch resumed at delta 1 (step 8), the final checkpoint
            bitwise the clean cli run of the same config (and that the
            in-process run, whose launches are counted); then
            kill_publish@2 (SIGKILL between delta 1's tmp file and its
            rename): resumed at the chain head (step 4), bitwise; the clean
            run and the two plans' runs at once
  follow    [Online] follow over the 393,216 train rows as an FMS stream
            (max_batches 24, idle timeout 5 s) at K = 1 and K = 8: over the
            file written whole, and over a file a writer thread appends in
            bursts while the run trains (a torn third append, a 1 s stall
            halfway): each live run bitwise its whole-file run, every run
            within TABLE_ATOL of the CPU's, the stall in the live runs'
            kind=input records, ex/s and the card's idle share (traced);
            cli train SIGTERMed while its reader polls an idle stream exits
            0 with the cursor at batch 12 and resumes bitwise
  accum_restart accum_restart_steps = 16 on the device cache, 24 steps, at
            K = 1 and K = 8 (graphed): one reset after step 16 in each,
            every accumulator at the init value right after it, the runs
            bitwise equal; the reset's ms and each run's step time
  wire      FMB input (binary_cache) with wire_format = packed (at K = 8
            each K-group packed into one pinned buffer, one H2D, unpacked on
            the card on a side stream; at K = 1 the loop converts) against
            arrays, from one seeded npz, at K = 1 (24 steps) and K = 8 (48):
            losses and final tables bitwise, the H2D bytes per batch from
            kind=input against the spec's (from the FMB flags; none at
            K = 1), ex/s, step p50 and the card's idle share
  tiered    [ParamStore] at baseline5's full width: hot_rows 262,144 of 2^20
            by the sample policy (8 batches), materialize auto (the store
            holds init_state's host draw), a delta every 8 steps and a full
            save at the epoch end; against resident runs from an npz of the
            same draw: K = 1 streamed text and K = 8 FMB (48 steps), losses,
            validation AUCs and the logical table and accumulator (store +
            hot tier) bitwise; the row accumulator, bitwise; the K = 1 run on
            the CPU within TABLE_ATOL; a run aborted at step 20 and resumed
            from its chain head, and a cli train --fault-plan
            kill_writeback@1 child (SIGKILL inside the first store apply)
            resumed, each bitwise the uninterrupted run.  Per run: ex/s over
            the run and per window, step p50, idle share, the kind=tiering
            counters (hit rate, miss rows, wire bytes, resolve, writeback,
            restages, pending rows) and the kernels' launches
  tiered_big baseline5's widths at vocabulary 2^31 - 1 (a resident table and
            element accumulator would need 154.6 GB): 8 x 16,384 rows of
            gen_synthetic over that vocabulary, a lazy store, hot_rows 2^20,
            the disk the written rows need reckoned from the data first;
            finite losses, peak device memory, the store files' apparent
            size against the pages the store's written rows occupy (at most
            the reckoning; the filesystem's used bytes during the run beside
            them as a second witness), the rows the final save applied read
            back from the store, and a resume at that save
  orbax_fixture  tests/data/jax_b5_rowmesh.orbax (the JAX package's save
            on a 2-way row mesh, zstd-compressed; tools/make_orbax_fixture.py)
            and its npz twin restored through the port onto the card:
            bitwise equal, the same cursor; libzstd's path (its absence
            fails the phase)
  dist_b2   configs/baseline2_fm_sharded.cfg at full width (order 2, k 16,
            V 2^24, max_nnz 39, batch 16,384) with its own checkpoint_format
            = orbax and log_every 4, on 24 x 16,384 rows of gen_synthetic
            (--seed 3; started in the background at the run's start) and
            32,768 validation rows, every run in this process from the same
            fresh init: cli dist_train at world size 1 (traced) writes an
            orbax directory, cli train with npz its twin; cli dist_train and
            cli train with orbax stopped by SIGTERM at step 12 and resumed
            with --resume; cli dist_predict and cli predict from the
            directory against cli predict from the npz.  Logged losses, the
            2^24 x 17 table and accumulator, the cursor and the score files
            bitwise; B4 once per step and nothing else; each format's epoch
            save (stall, bytes, MB/s) and full restore onto the card (ms,
            in turns) side by side; step p50, ex/s, the card's idle share,
            peak device memory
  dist_b5   baseline5 through training.dist_train at world size 1 against
            training.train from one seeded npz, 24 steps each: rows,
            packed, fused, steps_per_call = 8 (traced) and lookup =
            alltoall, each bitwise (losses, logical table and accumulator),
            B1, B2 and the layout's tail once per step
  shard_update  the sharded update's shard apply on the card at R = 2 and
            4 with no process group: one seeded [2^20, 9] table in R
            shards, the world-gathered (uids, gsum) of R synthetic ranks
            from the first batch (unowned ids, sentinels); each shard's B4
            apply bitwise its plain twin and the R = 1 update's rows; B4
            packed and B3 fused on each shard bitwise the rows result;
            the routing buckets and send buffers equal to the CPU's; the
            applies' times
  nccl_world1  an NCCL group of world size 1: the general (R > 1-shaped)
            branches of sharded_gather, sharded_sparse_adagrad_update,
            routed_gather and routed_update against the fast path, then the
            sharded step (allgather and alltoall) eager and as a captured
            4-step CUDA graph against the single-device step, all bitwise
  dist_cached  baseline5 through dist_train with device_cache at world size
            1 against train with device_cache: rows K = 1 (4 epochs of the
            24-batch file, a fresh seeded init, a loss every step), rows and
            fused K = 8 over the 1,048,576-row epoch (traced), rows K = 1
            with a delta every 4 steps stopped by SIGTERM at step 10 and
            resumed; losses, logical table, accumulator and cursor bitwise,
            B1, B2 and the tail once per step; the cached sharded step's
            general branches through an NCCL group of one (K = 1, and K = 8
            in one graph) bitwise the fast path; step p50, idle share,
            resident MiB
  pod_card  a one-host pod: generation.json and the FM_DIST_* environment
            written here, `cli dist_train` (cached, delta every 4 steps) as
            the child on cuda, the file bumped to generation 1 after step
            8; the child re-execs with the same PID, joins generation 1,
            restores the chain head (a delta boundary >= 8, logged after
            the join; its first new step the next) and ends bitwise
            dist_cached's rows_k1
            run, its heartbeat at the last step; the bump-to-step wall
  bench     bench_torch.py from the checkout, as a user runs it (its full
            output under chiprun_out/drivers/): exit 0, no *_error key, a
            number for value, scale_value, packed_value, packed_b65536_value,
            zipf_interleaved_value, device_cached_value and
            toy_vocab1m_value, every scale_fallbacks entry an out-of-memory
            error, scale_implied_over_nominal <= 1.05; the K-step leg on the
            rung's own table (a K = 8 graph captured on a state over half
            the card) with its peak allocation above the live state under
            a quarter of the state
  kstep_big a K = 8 CUDA graph captured on a rows state over half the
            card's free memory: the peak above the live state under 2 GiB,
            the rows outside the batches' ids unchanged, the graphed steps
            bitwise the plain loop from the same state
  zipf_tail B4 at the packed address (element accumulator, 2^24 x 9) and B3
            on the fused array of the rung bench ran, at B 65,536 x 39
            Zipf(1.1) ids, each bitwise its plain twin (B3's on a compacted
            copy of the touched tile rows, the rest of the array
            unchanged); times and bounds
  bench_all bench_all_torch.py (the default sweep; in the whole script
            started beside the dist and quality phases and waited for before
            the throughput phase, so no measured phase runs beside it):
            exit 0, no FAILED row and no *_error key (a
            knee run), the fit line's train AUC >= 0.99
  loadgen   tools/torch_loadgen.py on baseline5 at full width (in the whole
            script beside the telemetry_train .. tiered_big phases, whose
            gates are bitwise or functional; alone under --only drivers): closed loop
            in process, open loops at 25/50/75% of its rate; a 2-replica
            tier's closed loop, JSONL open loop and --stats over --connect;
            a --spawn open loop over binary frames at half the tier's closed
            rate; --probe-freshness 3: no
            request unanswered (every one sent scored or shed, in process
            too), no error below saturation, no steady-state
            recompile (every run's object in
            chiprun_out/drivers/BENCH_SERVE_TORCH.json)
  tools     the chaos, soak and beyond-HBM tools as a user runs them (their
            output under chiprun_out/tools/; in the whole script beside
            the bench, kstep_big and zipf_tail phases), the four at once:
            tools/torch_chaos.py --trials 1 --sharded (train and dist_train
            under `--supervised` with a seeded kill: every step's loss
            bitwise the uninterrupted run's, one crash, one restart with
            an MTTR); tools/torch_probe_tier.py --vocab 2147483647
            --steps 8 (the tiered store past the card: hit_rate_gap <=
            0.02, no steady recompile, B4 launched);
            tools/torch_chaos.py --serve (no request unanswered, every
            delivered score bitwise the fault-free run's, a replica
            restart, a torn reload attempted and survived);
            tools/torch_soak.py --smoke --minutes 0.3 (gate OK, every
            request answered, the trainer killed and back, a stream stall,
            two ticks or more); meanwhile chaos's train
            config in process on the card (bitwise the CLI child's final
            checkpoint; B4 once per step) and on the CPU from the card
            run's initial state (within TABLE_ATOL)
  quality   the quality tools as a user runs them (their output under
            chiprun_out/tools/; in the whole script beside dist_b2), the
            three at once: tools/torch_quality_zoo.py --quick (ffm, fm3,
            deepfm and its FM baseline), tools/torch_backtest.py --quick
            (gate OK) and tools/torch_scaling_study.py at one 200,000-row
            point and one epoch (its oracle 0.91053): exit 0, every
            held-out AUC above 0.5 and at most its oracle + 0.01, B4 in
            every artifact's kernel_launches, B1 and B2 in the zoo's;
            meanwhile the zoo's fm3 config (order 3, its --quick data) in
            process on the card and on the CPU from one seeded npz:
            validation AUCs within 0.002, tables within TABLE_ATOL, B1, B2
            and B4 in every step
  kernels   one record per kernel: route, source, launches (the wrappers'
            counts over the eager train run; B3's over train_fused;
            launches_by_run adds the graphed train_cached runs' replays, and
            for B4 the zoo's, resume, convert, packed and dedup runs, for B3
            the fused resume runs), error and times at the training shapes
            (B4's `shapes` adds baseline1's and baseline3's, its `packed`
            the packed address); launches_by_run adds the telemetry_* and
            ckpt_* runs (K-step runs: the replays in their traces), the
            rollback, supervised reference, follow and accum_restart runs,
            and for B1 serve_reload's engine and each replica process's
            launches during serve_socket's traffic (serve_socket_r0, _r1); the
            wire, tiered and tiered_big runs; dist_b2's six runs and the
            dist_b5 runs;
            the dist_cached runs (K = 8: the replays in their traces); the
            drivers' runs (bench_torch, bench_all_torch: each process's
            wrapper counts; loadgen_*: each in-process engine's and each
            replica's B1 launches); B4's and B3's `shapes` add the Zipf
            shapes (zipf_packed_b65536, zipf_fused_b65536); B4's adds the
            tools' runs (chaos_reference, probe_tier); B1's, B2's and B4's
            the quality runs (quality_fm3, quality_zoo, quality_backtest,
            quality_study); the order-2 pair's (fm2_fwd, fm2_bwd) launches
            are the zoo's train_fm2 run's, and its launches_by_run
            train_deepfm, the graphed DeepFM's replays and every other run
            above that scored at order 2; the DCN-V2 pair's (dcn_cross_fwd,
            dcn_cross_bwd) are train_dcnv2's

Every traced training run also counts each kernel by name in its profiler
trace (launches_traced); an eager run's count must equal its wrappers'.
One exception, the one loss the profiler has shown: a trace that lacks the
run's first forward launch, and nothing else, in three attempts keeps the
wrappers' counts and records trace_lost_events.

The last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.
``--only fm2`` runs the device, build, ANOVA, fm2_score and dcn_cross phases
alone; ``--only dcnv2`` those and the data, data_zoo and DCN-V2 phases;
``--only dist`` runs the device, build and data phases and the four phases
of dist_train alone, ``--only pod`` those and dist_cached and pod_card,
``--only orbax`` those and orbax_fixture, serve_reload's orbax case (on
the fixture's states) and dist_b2, ``--only drivers`` those and the
bench, zipf_tail, bench_all and loadgen phases, ``--only tools`` the
device, build and data phases and the tools phase, ``--only quality``
those and the quality phase; none prints the
result line (development runs).
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# The H100 SXM's published peaks (NVIDIA data sheet) for the bound column.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

SEED = 20261016
RTOL, ATOL = 1e-5, 1e-6
SERVE_LINES = 4096
NNZ = 11
KERNELS = ["anova_fwd", "anova_bwd", "rows_tail_adagrad", "fused_tail_adagrad", "fm2_fwd",
           "fm2_bwd", "dcn_cross_fwd", "dcn_cross_bwd"]
# The CUDA sources (csrc/<name>.cu) those kernels are built from: the
# order-2 pair shares one, and so does the DCN-V2 pair.
SOURCES = ["anova_fwd", "anova_bwd", "rows_tail_adagrad", "fused_tail_adagrad", "fm2_score",
           "dcn_cross"]
# Each kernel's function names (csrc/*.cu), by which a profiler trace counts
# what ran on the card.
KERNEL_SYMBOLS = {
    "anova_fwd": ("anova_fwd_kernel",),
    "anova_bwd": ("anova_bwd_kernel",),
    "rows_tail_adagrad": ("rows_element_kernel", "rows_row_kernel"),
    "fused_tail_adagrad": ("fused_slot_kernel",),
    "fm2_fwd": ("fm2_fwd_kernel",),
    "fm2_bwd": ("fm2_bwd_kernel",),
    "dcn_cross_fwd": ("dcn_cross_fwd_kernel",),
    "dcn_cross_bwd": ("dcn_cross_bwd_kernel",),
}
# Each backward kernel's forward: a step launches the forward first.
FORWARD_OF = {"anova_bwd": "anova_fwd", "fm2_bwd": "fm2_fwd", "dcn_cross_bwd": "dcn_cross_fwd"}
# The order-2 pair at the benchmark cells' batches (fm2_criteo1tb: B 16,384,
# N 39, D 17; deepfm_criteo1tb: B 8,192, D 9) and a ragged one; its λs
# large enough that the L2 term's gradient shows beside the score's.
FM2_SHAPES = [(16384, 39, 17), (8192, 39, 9), (130, 7, 5)]
FM2_LAMBDAS = (0.3, 0.7)
# The zoo's models that score through the order-2 pair.
ORDER2_ZOO = ("fm2", "deepfm")
# The forward kernel serving runs for each model that has one.
SERVE_FORWARD = {"fm2": "fm2_fwd", "deepfm": "fm2_fwd", "dcnv2": "dcn_cross_fwd"}
# The DCN-V2 pair at the dcnv2 cell's cross layer (B 8,192, d 39·128) and
# ragged shapes: d 5 (one column a thread), d 4,991 (not a multiple of 4).
DCN_SHAPES = [(8192, 4992), (130, 5), (97, 4991)]
# DCN-V2 at full width on the zoo's criteo data (its vocabulary cut to the
# data's 2^20 rows), and the validation rows of its card-against-CPU
# gradient check.
DCNV2_CONFIG = os.path.join("configs", "torch", "dcnv2_criteo1tb.cfg")
DCNV2_GRAD_ROWS = 1024
# The operand precision at which DCN-V2's card is held to the CPU.  At the
# cfg's bfloat16 operands another float32 summation order alone (the CPU's
# float64 sums against its float32 ones, the cfg's widths, 1,024 rows) moves
# the gradients by 1.0-1.1e-2 by relative norm and the scores by up to 2e-4:
# the rounding of every operand and gradient to bf16 turns ulp differences
# into whole bf16 steps through 3 cross layers and 5 MLP layers.  At float32
# the same reading is under 7e-7 and 2e-7, so ATOL holds the scores; the
# bf16 path is held to the plain reference by the benchmark cell's check.
DCNV2_CHECKED_DTYPE = "float32"
# The gradients' relative norm, card against CPU, at float32: a ReLU gate
# whose pre-activation lies within float32 ordering noise of 0 switches
# between the two, and one switched gate of a 1024-wide layer moves that
# layer's input gradient and every gradient below it by ~1e-3 (the card read
# 1.2-1.4e-3 on rows, the cross layers, w0, w1, b0 and b1, and under 7e-7 on
# w2-w4 and b2-b4, above the first two layers).  A fault of the composition
# (a layer's x0 part lost, a wrong sum across the layers) moves them by O(1).
DCNV2_GRAD_RTOL = 1e-2
ANOVA_SHAPES = [(b, NNZ, 8, order) for order in (3, 4) for b in (1, 8, 64, 512, 16384)]
ANOVA_SHAPES.append((130, 7, 5, 3))  # ragged: B off the block edge, k not dividing 32
BWD_SHAPES = [(b, NNZ, 8, order) for order in (3, 4) for b in (1, 512, 16384)]
BWD_SHAPES += [(130, 7, 5, 3), (2048, 39, 8, 3)]  # ragged; criteo's 39 features
# The quality zoo's fm3 batch (tools/torch_quality_zoo.py: B 8,192, 12 fields,
# k 4), drawn from its own seed so that every later phase keeps its data.
QUALITY_FM3_SHAPE, QUALITY_FM3_SEED = (8192, 12, 4, 3), SEED + 20
ANOVA_SHAPES.append(QUALITY_FM3_SHAPE)
BWD_SHAPES.append(QUALITY_FM3_SHAPE)
TRAIN_SHAPE = (16384, NNZ, 8, 3)  # baseline5's training batch
BATCH = 16384  # baseline5's batch_size
TRAIN_BATCHES, VALID_BATCHES = 24, 2
THROUGHPUT_BATCHES = 64  # the config's epoch: 64 x 16384 = 1,048,576 rows
POD_EPOCHS = 4  # dist_cached rows_k1 and pod_card: 4 epochs of the 24-batch file
POD_DELTA_EVERY = 4  # pod_card's delta cadence: the child restores a multiple of it
# The card's trained table and accumulators against the CPU run's.  24 steps
# move a factor element by ~1e-7 or less, so 1e-5 would pass a run that
# dropped them: the atol sits near the float32 spacing of the table's values
# (~1e-9 at 0.01, ~7e-9 at the accumulators' 0.1), and the updates
# themselves (final minus initial table) are held per column group, by
# relative norm and by the count of elements they moved.
TABLE_ATOL, AUC_TOL = 1e-7, 0.002
UPDATE_RTOL, MOVED_RTOL = 1e-2, 1e-3
CONFIG = os.path.join("configs", "baseline5_fm_order3_kdd.cfg")
# baseline5 on the fused lane-packed layout: no shipped config sets these.
FUSED = {"table_layout": "packed", "adagrad_accumulator": "fused"}
# The model zoo at the configs' full widths: {key: (config, data set)}.
ZOO = {
    "fm2": (os.path.join("configs", "baseline1_fm_criteo_sample.cfg"), "criteo"),
    "ffm": (os.path.join("configs", "baseline3_ffm_avazu.cfg"), "avazu"),
    "deepfm": (os.path.join("configs", "baseline4_deepfm_criteo.cfg"), "criteo"),
}
# The zoo's data, cut in depth only: 262,144 criteo-shaped rows (16 steps
# of baseline1's 16,384, 32 of baseline4's 8,192) and 131,072 avazu-shaped
# ones (16 steps of baseline3's 8,192) instead of the headers' 1M, 16,384
# validation rows instead of 100,000.
ZOO_DATA = {
    "criteo": dict(fields=39, train=16 * 16384, valid=16384, seeds=(1, 2), ext="libsvm", args=[]),
    "avazu": dict(fields=22, train=16 * 8192, valid=16384, seeds=(5, 6), ext="libffm",
                  args=["--format", "libffm", "--binary-vals"]),
}
ZOO_SERVE_LINES = 4096
# Scores of a bfloat16 DeepFM, card against CPU: both round the same float32
# operands to bfloat16, but a hidden activation that differs in its last
# float32 bit between the two (the sums run in another order) can round to
# the neighbouring bfloat16 value, 2^-8 of it, and that moves the score by
# ~1e-5; atol 1e-4 holds a few such flips and no wrong layer.
BF16_SCORE_ATOL = 1e-4
# DeepFM, card against CPU.  One step from one state agrees to the float32
# summation order (float32 compute: the gradients within 1e-5 by relative
# norm) or to one bfloat16 rounding step (2^-8).  Over a run the MLP's
# Adagrad steps amplify those last-bit differences: the end states of the
# two runs differ by percents where one step's gradients differ by 1e-4
# (train_deepfm's gradient and updates records).  So a DeepFM run's
# updates are held by relative norm within 0.25 (a run that dropped the
# deep half's gradient or the dense update is ~1 off), beside the
# one-step gradient check and the AUC.
MLP_GRAD_RTOL = {"float32": 1e-5, "bfloat16": 2.0**-8}
MLP_DRIFT_RTOL = 0.25


T0 = time.perf_counter()
_EMIT_LOCK = threading.Lock()  # a phase beside the main thread emits too


def emit(obj) -> None:
    with _EMIT_LOCK:
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()
    if isinstance(obj, dict) and "phase" in obj:  # the script's clock at each phase's record
        log_stderr(f"chip_smoke: {time.perf_counter() - T0:.1f} s: {obj['phase']}")


class _Beside(threading.Thread):
    """``fn(*args)`` on a thread of its own, started at once, beside the
    main thread's phases; ``result()`` waits for it and returns its value,
    or raises what it raised (a ``fail`` there ends the script here).  Only
    a phase whose kernels run in its own subprocesses goes beside: the
    wrappers' counts are the main thread's."""

    def __init__(self, fn, *args):
        super().__init__(name=fn.__name__, daemon=True)
        self._call, self._value, self._raised = (fn, args), None, None
        self.start()

    def run(self):
        fn, args = self._call
        try:
            self._value = fn(*args)
        except BaseException as e:  # noqa: BLE001 - handed to the main thread
            self._raised = e

    def result(self):
        self.join()
        if self._raised is not None:
            raise self._raised
        return self._value


def _children() -> list[int]:
    """The live and unreaped processes whose parent is this one."""
    me, out = str(os.getpid()), []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = f.read().rsplit(")", 1)[1].split()[1]
        except (OSError, IndexError):
            continue
        if ppid == me:
            out.append(int(pid))
    return out


def _stop_children() -> None:
    """SIGKILL every process this script started that is still there, its
    subprocesses too: main() makes this process their subreaper, so a
    process whose parent went is this one's child and the next round
    finds it.  Each one stopped is named on stderr."""
    for _ in range(20):
        pids = _children()
        if not pids:
            return
        for pid in pids:
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
                if cmd:  # a zombie has none: it has ended and is only reaped
                    log_stderr(f"chip_smoke: stopping process {pid} left running: {cmd[:300]}")
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        for pid in pids:
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass


@contextlib.contextmanager
def _reaping():
    """Makes this process the subreaper of every process it starts (Linux
    prctl PR_SET_CHILD_SUBREAPER, this process alone), turns SIGTERM into an
    exit, and on the way out stops whatever is still running
    (``_stop_children``), before the temporary directory goes."""
    import ctypes

    def on_term(signum, _):
        signal.signal(signal.SIGTERM, signal.SIG_IGN)  # a second one (a process group's) waits
        sys.exit(128 + signum)

    ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)  # PR_SET_CHILD_SUBREAPER
    signal.signal(signal.SIGTERM, on_term)
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        _stop_children()


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def log_stderr(*a):
    print(*a, file=sys.stderr, flush=True)


def time_ms(fn, reps: int) -> float:
    """Median of per-call times by CUDA events (after a warm-up call)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


_LAST_TRACE: list = []  # (start µs, kernel) of KERNELS in the last trace


def trace_device(fn):
    """Run ``fn`` once under torch.profiler (CUDA activity, i.e. CUPTI) and
    return its device events as (category, name, microseconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()  # the tracing settled before fn's first launch
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    # The order of the kernels' launches, for a trace that disagrees with
    # the wrappers' counts (_counted_run logs it).
    _LAST_TRACE[:] = sorted(
        (float(e["ts"]), name) for e in events
        if str(e.get("cat", "")).lower() == "kernel" and "ts" in e
        for name, syms in KERNEL_SYMBOLS.items() if any(sym in e.get("name", "") for sym in syms)
    )
    return [
        (str(e.get("cat", "")).lower(), e.get("name", ""), float(e["dur"]))
        for e in events
        if str(e.get("cat", "")).lower() in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e
    ]


def traced_window(fn) -> dict:
    """``fn`` under the profiler, its wall time taken inside the traced
    region (so the profiler's own start and export are not counted): the
    card's busy time, idle share of that wall time, top kernels and how
    many times each of KERNELS ran (``launches_traced``).  A trace without
    device events gives None for busy and idle, and one without kernel
    events None for the counts (not measured)."""
    import torch

    wall = []

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    events = trace_device(timed)
    by_name: dict[str, float] = {}
    for _, name, dur in events:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + dur / 1e3
    busy_ms = sum(dur for _, _, dur in events) / 1e3 if events else None
    kernels = [name for cat, name, _ in events if cat == "kernel"]
    order = [k for _, k in _LAST_TRACE]
    return {
        "first_traced": order[0] if order else None,
        # backward launches with no forward just before them (of KERNELS)
        "bwd_without_fwd": sum(k in FORWARD_OF and (i == 0 or order[i - 1] != FORWARD_OF[k])
                               for i, k in enumerate(order)),
        "launches_traced": {
            k: sum(any(sym in name for sym in syms) for name in kernels)
            for k, syms in KERNEL_SYMBOLS.items()
        } if kernels else None,
        "wall_ms": 1e3 * wall[0],
        "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / (1e3 * wall[0]),
        "device_ms_by_kernel": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]),
    }


def device_ms(fn, reps: int, name: str | None):
    """Device time per call from a profiler trace of ``reps`` calls: the
    median duration of the kernels whose name contains ``name``, or with
    ``name`` None the summed duration of every kernel per call.  A trace
    sometimes comes back without kernel events; after three such traces
    this gives None (not measured)."""
    fn()

    def many():
        for _ in range(reps):
            fn()

    for _ in range(3):
        durs = [
            d for cat, n, d in trace_device(many)
            if cat == "kernel" and (name is None or name in n)
        ]
        if durs:
            break
    else:
        return None
    if name is None:
        return sum(durs) / reps / 1e3
    durs.sort()
    return durs[len(durs) // 2] / 1e3


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time in ms: bytes over the memory rate or float32
    operations over the peak rate, whichever is larger, and which it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def anova_bound(b: int, n: int, k: int, order: int) -> tuple[float, str]:
    """Forward: z read once, out written once; 2 flops per fma of the DP
    plus the degree sums."""
    return _bound(4 * (b * n * k + b), b * k * (2 * order * n + (order - 1)))


def bwd_bound(b: int, n: int, k: int, order: int) -> tuple[float, str]:
    """Backward: z and g read once, zbar written once; per (example,
    factor) the forward recompute (N·order fma) and the reverse DP
    (2·N·(order−1) fma), 2 flops each."""
    return _bound(4 * (2 * b * n * k + b), 2 * b * k * n * (3 * order - 2))


def tail_bound(m: int, k: int, d: int, a: int) -> tuple[float, str]:
    """The tail kernels' work: M sorted occurrences onto K unique rows.
    Per occurrence the sorted id (4 B), the sort's int64 index and the
    gradient row read once, one add per gradient element; per unique row
    the table row and its A accumulator floats (a fused slot: A = 1) read
    and written once, ~6 flops a table element (g², add, lr·g, sqrt,
    divide, subtract).  On deduped input M = K."""
    return _bound(m * (4 + 8 + 4 * d) + k * 8 * (d + a), m * d + 6 * k * d)


def tail_sector_bound(m: int, k: int, d: int, a: int, fused: bool) -> float:
    """``tail_bound``'s bytes counted in the 32-byte sectors the card moves:
    a random row of b bytes at an a-byte aligned offset spans (b - a)/32 + 1
    sectors on average (a 36-byte table row 2, a 4-byte row accumulator 1,
    a 40-byte fused slot 2).  The sorted ids and indices stream whole.
    Returns ms at the memory rate."""
    spans = lambda b, align: (b - align) / 32 + 1  # noqa: E731
    row = 2 * 32 * (spans(4 * (d + 1), 8) if fused else spans(4 * d, 4) + spans(4 * a, 4))
    return 1e3 * (m * (12 + 32 * spans(4 * d, 4)) + k * row) / HBM_BYTES_PER_S


def flushed(fn):
    """``fn`` after writing a 64 MiB buffer, more than the H100's 50 MB L2,
    so ``fn`` finds none of its operands in the cache."""
    import torch

    buf = torch.empty(16 << 20, device="cuda")

    def run():
        buf.fill_(1.0)
        fn()

    return run


def _padded_batch(ids, grads, real: int = 1000):
    """The first ``real`` rows of a batch, padded back to its size as
    data/libsvm.pad_batch pads a short last batch: every pad slot id 0,
    with the zero gradient a weight-0 row gets."""
    hot_ids, hot_grads = ids.clone(), grads.clone()
    hot_ids[real:] = 0
    hot_grads[real:] = 0.0
    return hot_ids, hot_grads


def _tail_timings(kern: str, kernel, update, apply, dedup, dedup_apply, hot, plain) -> dict:
    """The tail timings of one call: the kernel alone on the sort's output
    (events; device time by name, L2-warm and after a 64 MiB write), the
    update (sort + kernel), the kernel on deduped input, the dedup alone,
    the dedup + kernel on its output (a separate dedup pass), the hot-id update
    and the plain twin on the sort's output."""
    return {
        "ms": time_ms(kernel, 100),
        "device_ms": device_ms(kernel, 30, kern),
        "device_ms_flushed": device_ms(flushed(kernel), 30, kern),
        "update_ms": time_ms(update, 100),
        "update_device_ms": device_ms(update, 30, None),
        "apply_ms": time_ms(apply, 100),
        "apply_device_ms": device_ms(apply, 30, kern),
        "dedup_ms": time_ms(dedup, 30),
        "dedup_device_ms": device_ms(dedup, 10, None),
        "dedup_apply_ms": time_ms(dedup_apply, 30),
        "dedup_apply_device_ms": device_ms(dedup_apply, 10, None),
        "hot_update_ms": time_ms(hot, 10),
        "hot_update_device_ms": device_ms(hot, 5, None),
        "hot_device_ms": device_ms(hot, 5, kern),
        "plain_ms": time_ms(plain, 30),
        "plain_device_ms": device_ms(plain, 10, None),
    }


def _check_close(name: str, got, want, rtol: float, atol: float, where: str) -> tuple[float, float]:
    """Max abs and rel error of ``got`` against ``want``; fails outside the
    tolerance."""
    import torch

    diff = (got - want).abs()
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel_err = float((diff / want.abs().clamp_min(1e-30)).max()) if diff.numel() else 0.0
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{name} disagrees with its plain version at {where}: max abs err "
             f"{abs_err}, max rel err {rel_err} (rtol {rtol}, atol {atol})")
    return abs_err, rel_err


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    info = {
        "phase": "device",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    emit(info)
    return info


def _ptxas_report(log: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel
    function in nvcc's ``-Xptxas=-v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?(fm2_[a-z]+_kernel|[a-z][a-z_]*_kernel)"
                      r"(?:IL[ib](\d+)E)?", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            out[name].update(registers=int(m.group(1)), smem_bytes=int(m.group(2)))
    return out


def phase_build():
    from fast_tffm_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    report = kernel_build.build(SOURCES)
    for name, r in report.items():
        log_stderr(f"--- nvcc {name} ---\n{r['log'].strip()}")
    emit({
        "phase": "build",
        "seconds": round(time.perf_counter() - t0, 3),
        "kernels": {k: round(v["seconds"], 3) for k, v in report.items()},
        "ptxas": {k: _ptxas_report(v["log"]) for k, v in report.items()},
    })


def _z(rng, b: int, n: int, k: int):
    """z = v·x as the serving and training paths form it: factors
    v ~ U(±0.25), values x ~ U(0, 1]."""
    import numpy as np
    import torch

    v = rng.uniform(-0.25, 0.25, size=(b, n, k))
    x = 1.0 - rng.random((b, n, 1))
    return torch.from_numpy((v * x).astype(np.float32)).cuda()


def _shape_rng(rng, shape):
    """The generator an ANOVA hold draws ``shape``'s inputs from: ``rng``,
    or the quality zoo's batch's own."""
    import numpy as np

    return np.random.default_rng(QUALITY_FM3_SEED) if shape == QUALITY_FM3_SHAPE else rng


def phase_anova(rng):
    import torch

    from fast_tffm_tpu_torch.ops.anova import anova_inter, anova_inter_plain

    worst, main = 0.0, None
    for b, n, k, order in ANOVA_SHAPES:
        r = _shape_rng(rng, (b, n, k, order))
        z = _z(r, b, n, k)
        got = anova_inter(z, order)
        want = anova_inter_plain(z, order)
        torch.cuda.synchronize()
        abs_err, rel_err = _check_close(
            "anova_fwd", got, want, RTOL, ATOL, f"B={b} N={n} k={k} order={order}"
        )
        bound_ms, bound_by = anova_bound(b, n, k, order)
        rec = {
            "phase": "anova_fwd", "B": b, "N": n, "k": k, "order": order,
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "ms": time_ms(lambda: anova_inter(z, order), 200),
            "plain_ms": time_ms(lambda: anova_inter_plain(z, order), 50),
            "device_ms": device_ms(lambda: anova_inter(z, order), 50, "anova_fwd_kernel"),
            "plain_device_ms": device_ms(lambda: anova_inter_plain(z, order), 20, None),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit(rec)
        worst = max(worst, abs_err)
        if (b, n, k, order) == TRAIN_SHAPE:
            main = rec
    return worst, main


def phase_anova_bwd(rng):
    import numpy as np
    import torch

    from fast_tffm_tpu_torch.ops.anova import anova_inter_bwd, anova_inter_bwd_plain

    worst, main = 0.0, None
    for b, n, k, order in BWD_SHAPES:
        r = _shape_rng(rng, (b, n, k, order))
        z = _z(r, b, n, k)
        g = torch.from_numpy(r.uniform(-1.0, 1.0, size=b).astype(np.float32)).cuda()
        got = anova_inter_bwd(z, g, order)
        want = anova_inter_bwd_plain(z, g, order)
        torch.cuda.synchronize()
        abs_err, rel_err = _check_close(
            "anova_bwd", got, want, RTOL, ATOL, f"B={b} N={n} k={k} order={order}"
        )
        bound_ms, bound_by = bwd_bound(b, n, k, order)
        rec = {
            "phase": "anova_bwd", "B": b, "N": n, "k": k, "order": order,
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "ms": time_ms(lambda: anova_inter_bwd(z, g, order), 100),
            "plain_ms": time_ms(lambda: anova_inter_bwd_plain(z, g, order), 20),
            "device_ms": device_ms(lambda: anova_inter_bwd(z, g, order), 30, "anova_bwd_kernel"),
            "plain_device_ms": device_ms(lambda: anova_inter_bwd_plain(z, g, order), 5, None),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit(rec)
        worst = max(worst, abs_err)
        if (b, n, k, order) == TRAIN_SHAPE:
            main = rec
    return worst, main


def fm2_bounds(b: int, n: int, d: int) -> dict:
    """The order-2 pair's least time (ms, and what bounds it): forward,
    backward and the two.  Forward: rows and vals read once; scores, s1
    and the L2 partials written once; per row element a multiply, an add,
    two fmas (7 flops).  Backward: rows, vals, s1 and the score cotangents
    read once, d_rows written once; ~6 flops a row element."""
    rows, vals, s1 = b * n * d, b * n, b * (d - 1)
    fwd = (4 * (rows + vals + s1 + 2 * b), 7 * rows)
    bwd = (4 * (2 * rows + vals + s1 + b), 6 * rows)
    out = {}
    for name, (nbytes, flops) in (("fwd", fwd), ("bwd", bwd),
                                  ("pair", (fwd[0] + bwd[0], fwd[1] + bwd[1]))):
        out[f"{name}_bound_ms"], out[f"{name}_bound_by"] = _bound(nbytes, flops)
    return out


def phase_fm2(rng) -> dict:
    """The order-2 FM score and L2 kernel pair (csrc/fm2_score.cu) against
    its plain twin (``_FmScoreOrder2`` + ``masked_l2`` under autograd) on
    the card at FM2_SHAPES: scores and d_rows within 1e-5 of their largest
    magnitude, the L2 term within rtol 1e-5 (float32 sums in other
    orders); each kernel's median time per call by CUDA events and its
    device time in a trace, the pair's, its bound and the twin's forward
    plus backward.  Returns (the worst d_rows error, the fm2 cell's
    record)."""
    import numpy as np
    import torch

    from fast_tffm_tpu_torch.ops.fm import (
        _FmScoreOrder2,
        fm2_score_bwd,
        fm2_score_fwd,
        fm2_score_l2,
        masked_l2,
    )

    def twin(r, v, lam_b, lam_f):
        return _FmScoreOrder2.apply(r, v), masked_l2(r, v, lam_b, lam_f)

    def pair(fn, rows, vals, g, g_reg):
        r = rows.detach().requires_grad_(True)
        scores, reg = fn(r, vals, *FM2_LAMBDAS)
        (d_rows,) = torch.autograd.grad((scores, reg), r, (g, g_reg))
        return scores.detach(), reg.detach(), d_rows

    worst, main = 0.0, None
    for b, n, d in FM2_SHAPES:
        rows = torch.from_numpy((rng.normal(size=(b, n, d)) * 0.3).astype(np.float32)).cuda()
        x = rng.uniform(0.1, 1.0, size=(b, n)).astype(np.float32)
        x[:, -1] = 0.0
        vals = torch.from_numpy(x).cuda()
        g = torch.from_numpy(rng.normal(size=b).astype(np.float32)).cuda()
        g_reg = torch.tensor(1.7, device="cuda")
        got, want = pair(fm2_score_l2, rows, vals, g, g_reg), pair(twin, rows, vals, g, g_reg)
        torch.cuda.synchronize()
        errs = {}
        for what, i in (("scores", 0), ("d_rows", 2)):
            scale = float(want[i].abs().max())
            errs[what] = _check_close(f"fm2 {what}", got[i], want[i], 0.0, 1e-5 * scale,
                                      f"B={b} N={n} D={d}")[0]
        errs["reg"] = _check_close("fm2 reg", got[1], want[1], 1e-5, 0.0, f"B={b} N={n} D={d}")[0]
        s1 = torch.empty((b, d - 1), device="cuda")
        lam = FM2_LAMBDAS

        def fwd():
            fm2_score_fwd(rows, vals, lam, True)

        def bwd():
            fm2_score_bwd(rows, vals, s1, g, g_reg, lam)

        rec = {
            "phase": "fm2_score", "B": b, "N": n, "D": d,
            "max_abs_err": errs,
            "fwd_ms": time_ms(fwd, 200), "bwd_ms": time_ms(bwd, 200),
            "ms": time_ms(lambda: pair(fm2_score_l2, rows, vals, g, g_reg), 100),
            "plain_ms": time_ms(lambda: pair(twin, rows, vals, g, g_reg), 50),
            "fwd_device_ms": device_ms(fwd, 50, "fm2_fwd_kernel"),
            "bwd_device_ms": device_ms(bwd, 50, "fm2_bwd_kernel"),
            "plain_device_ms": device_ms(lambda: pair(twin, rows, vals, g, g_reg), 10, None),
            **fm2_bounds(b, n, d),
        }
        if rec["fwd_device_ms"] is not None and rec["bwd_device_ms"] is not None:
            rec["device_ms"] = rec["fwd_device_ms"] + rec["bwd_device_ms"]
        else:
            rec["device_ms"] = None
        rec["bound_ms"], rec["bound_by"] = rec["pair_bound_ms"], rec["pair_bound_by"]
        emit(rec)
        worst = max(worst, errs["d_rows"])
        if (b, n, d) == FM2_SHAPES[0]:
            main = rec
    return worst, main


# tools/gen_synthetic.py's files, byte for byte, a block of rows at a time.
GEN_SYNTHETIC = os.path.join(HERE, "tools", "torch_gen_synthetic.py")


def dcn_bounds(b: int, d: int) -> dict:
    """The DCN-V2 pair's least time (ms, and what bounds it) over [B, d]
    rows: forward, x0, h and x_l read once and y written once (16 B and 3
    flops an element); backward, g, x0 and h read once, d_h and x0's
    gradient written once (20 B and 4 flops); and the two."""
    n = b * d
    out = {}
    for name, (nbytes, flops) in (("fwd", (16 * n, 3 * n)), ("bwd", (20 * n, 4 * n)),
                                  ("pair", (36 * n, 7 * n))):
        out[f"{name}_bound_ms"], out[f"{name}_bound_by"] = _bound(nbytes, flops)
    return out


def phase_dcn_cross(rng) -> tuple:
    """The DCN-V2 cross combine pair (csrc/dcn_cross.cu) against its plain
    twin (``cross_fwd_plain`` under autograd) on the card at DCN_SHAPES:
    y, d_h and d_x0 bitwise, d_c (the bias sum, per-chunk partials summed
    in another order) within 1e-5 of its largest magnitude; each kernel's
    median time per call by CUDA events and its device time in a trace
    (the backward writing d_x0, and adding into it as every layer but the
    last does), the pair's, its bound and the twin's forward plus
    backward.  Returns (the worst d_c error, the cell's record)."""
    import numpy as np
    import torch

    from fast_tffm_tpu_torch.ops.dcn import (
        cross_combine,
        cross_fwd_plain,
        dcn_cross_bwd,
        dcn_cross_fwd,
    )

    def pair(fn, args, g):
        leaves = [a.detach().requires_grad_(True) for a in args]
        y = fn(*leaves)
        return (y.detach(), *torch.autograd.grad(y, leaves, g))

    worst, main = 0.0, None
    for b, d in DCN_SHAPES:
        x0, h, xl, g = (torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).cuda()
                        for _ in range(4))
        c = torch.from_numpy(rng.normal(size=d).astype(np.float32)).cuda()
        args = (x0, h, c, xl)
        got, want = pair(cross_combine, args, g), pair(cross_fwd_plain, args, g)
        torch.cuda.synchronize()
        for what, i in (("y", 0), ("d_x0", 1), ("d_h", 2)):
            if not torch.equal(got[i], want[i]):
                fail(f"dcn_cross {what} is not bitwise its plain twin's at B={b} d={d}")
        err = _check_close("dcn_cross d_c", got[3], want[3], 0.0,
                           1e-5 * float(want[3].abs().max()), f"B={b} d={d}")[0]
        acc = torch.zeros_like(x0)

        def fwd():
            dcn_cross_fwd(x0, h, c, xl)

        def bwd():
            dcn_cross_bwd(g, x0, h, c, None, 1)

        def bwd_add():
            dcn_cross_bwd(g, x0, h, c, acc, 2)

        rec = {
            "phase": "dcn_cross", "B": b, "d": d, "bitwise": True, "d_c_max_abs_err": err,
            "fwd_ms": time_ms(fwd, 100), "bwd_ms": time_ms(bwd, 100),
            "bwd_add_ms": time_ms(bwd_add, 100),
            "ms": time_ms(lambda: pair(cross_combine, args, g), 50),
            "plain_ms": time_ms(lambda: pair(cross_fwd_plain, args, g), 20),
            "fwd_device_ms": device_ms(fwd, 30, "dcn_cross_fwd_kernel"),
            "bwd_device_ms": device_ms(bwd, 30, "dcn_cross_bwd_kernel"),
            "bwd_add_device_ms": device_ms(bwd_add, 30, "dcn_cross_bwd_kernel"),
            "plain_device_ms": device_ms(lambda: pair(cross_fwd_plain, args, g), 10, None),
            **dcn_bounds(b, d),
        }
        if rec["fwd_device_ms"] is not None and rec["bwd_device_ms"] is not None:
            rec["device_ms"] = rec["fwd_device_ms"] + rec["bwd_device_ms"]
        else:
            rec["device_ms"] = None
        rec["bound_ms"], rec["bound_by"] = rec["pair_bound_ms"], rec["pair_bound_by"]
        emit(rec)
        worst = max(worst, err)
        if (b, d) == DCN_SHAPES[0]:
            main = rec
    return worst, main


def _generate(jobs) -> None:
    """tools/torch_gen_synthetic.py (gen_synthetic.py's command line and
    bytes) once per (path, rows, arguments) job, every job started at once."""
    gen = GEN_SYNTHETIC
    procs = []
    for path, rows, args in jobs:
        cmd = [sys.executable, gen, "--rows", str(rows), "--vocab", str(1 << 20),
               "--out", path, *args]
        procs.append((path, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                             stderr=subprocess.PIPE, text=True)))
    for path, proc in procs:
        try:
            _, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for _, p in procs:
                p.kill()
                p.wait()
            fail(f"gen_synthetic ({path}) did not finish in 300 s")
        if proc.returncode != 0:
            fail(f"gen_synthetic ({path}) failed with exit {proc.returncode}: {err}")


def phase_data(tmp: str) -> tuple[str, str]:
    """baseline5-shaped libsvm files, all three generated at once."""
    t0 = time.perf_counter()
    out = {name: os.path.join(tmp, f"baseline5.{name}.libsvm") for name in ("train", "valid", "big")}
    _generate([(out[name], batches * BATCH, ["--fields", str(NNZ), "--seed", str(seed)])
               for name, batches, seed in (("train", TRAIN_BATCHES, 7), ("valid", VALID_BATCHES, 8),
                                           ("big", THROUGHPUT_BATCHES, 9))])
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "train_rows": TRAIN_BATCHES * BATCH, "valid_rows": VALID_BATCHES * BATCH,
          "throughput_rows": THROUGHPUT_BATCHES * BATCH})
    return out["train"], out["valid"], out["big"]


def phase_data_zoo(tmp: str) -> dict:
    """The zoo's inputs, all four files at once with the seeds of the
    configs' headers: criteo-shaped libsvm (39 fields; baselines 1 and 4)
    and avazu-shaped libffm (22 fields, binary values; baseline 3).
    Returns {data set: (train path, validation path)}."""
    t0 = time.perf_counter()
    paths, jobs = {}, []
    for data, spec in ZOO_DATA.items():
        paths[data] = tuple(os.path.join(tmp, f"{data}.{part}.{spec['ext']}")
                            for part in ("train", "valid"))
        for path, rows, seed in zip(paths[data], (spec["train"], spec["valid"]), spec["seeds"]):
            jobs.append((path, rows, ["--fields", str(spec["fields"]), "--seed", str(seed),
                                      *spec["args"]]))
    _generate(jobs)
    emit({"phase": "data_zoo", "seconds": time.perf_counter() - t0,
          **{data: {k: spec[k] for k in ("fields", "train", "valid", "seeds")}
             for data, spec in ZOO_DATA.items()}})
    return paths


def _first_batch_ids(path: str, vocab: int, batch: int = BATCH, nnz: int = NNZ):
    import itertools

    import numpy as np

    from fast_tffm_tpu_torch.data.libsvm import parse_lines

    with open(path) as f:
        lines = list(itertools.islice(f, batch))
    return parse_lines(lines, vocabulary_size=vocab, max_nnz=nnz).ids.astype(np.int32)


def phase_rows_tail(rng, train_path: str):
    import numpy as np
    import torch

    from fast_tffm_tpu_torch.ops.tail import (
        rows_tail_adagrad_update,
        rows_tail_apply,
        rows_tail_sorted,
        rows_tail_sorted_plain,
    )
    from fast_tffm_tpu_torch.optim import dedup_rows, sparse_adagrad_update

    vocab, d, lr = 1 << 20, 1 + 8, 0.05
    ids = torch.from_numpy(_first_batch_ids(train_path, vocab)).cuda()
    grads = torch.from_numpy(
        (rng.normal(size=(BATCH, NNZ, d)) * 1e-3).astype(np.float32)).cuda()
    table = torch.from_numpy(rng.uniform(-0.01, 0.01, size=(vocab, d)).astype(np.float32)).cuda()
    accums = {
        "element": torch.from_numpy(rng.uniform(0.1, 0.5, size=(vocab, d)).astype(np.float32)).cuda(),
        "row": torch.from_numpy(rng.uniform(0.1, 0.5, size=(vocab, 1)).astype(np.float32)).cuda(),
    }
    sets = {
        "batch": (ids, grads),
        "one id": (ids[:1, :1], grads[:1, :1]),
        "1001 ids": (torch.unique(ids)[:1001].to(torch.int32),  # K = 1001 = 7·11·13
                     grads.reshape(-1, d)[:1001]),
        "hot id 0": _padded_batch(ids, grads),
    }
    cases = [
        ("element", 1.0, "batch"), ("element", 0.9, "batch"),
        ("row", 1.0, "batch"), ("row", 0.9, "batch"),
        ("element", 1.0, "one id"), ("row", 1.0, "one id"),
        ("element", 1.0, "1001 ids"), ("row", 0.9, "1001 ids"),
        ("element", 1.0, "hot id 0"), ("row", 0.9, "hot id 0"),
    ]
    main = None
    for acc, decay, which in cases:
        c_ids, c_grads = sets[which]
        t_k, a_k = table.clone(), accums[acc].clone()
        t_p, a_p = table.clone(), accums[acc].clone()
        rows_tail_adagrad_update(t_k, a_k, c_ids, c_grads, lr, decay=decay)
        sparse_adagrad_update(t_p, a_p, c_ids, c_grads, lr, decay=decay)
        torch.cuda.synchronize()
        k = int(torch.unique(c_ids).numel())
        where = f"{acc} accumulator, decay {decay}, {which} (K={k})"
        if not (torch.equal(t_k, t_p) and torch.equal(a_k, a_p)):
            err = float(max((t_k - t_p).abs().max(), (a_k - a_p).abs().max()))
            fail(f"rows_tail is not bitwise equal to its plain version: {where}, max abs err {err}")
        rec = {"phase": "rows_tail", "accumulator": acc, "decay": decay, "ids": which,
               "M": int(c_ids.numel()), "K": k, "bitwise": True, "max_abs_err": 0.0}
        if which == "batch" and decay == 1.0:
            flat_ids, flat_g = c_ids.reshape(-1), c_grads.reshape(-1, d)
            uids, gsum = dedup_rows(flat_ids, flat_g)
            sid, order = torch.sort(flat_ids, stable=True)
            hot_ids, hot_grads = sets["hot id 0"]
            m, a = flat_ids.numel(), a_k.shape[1]
            rec.update(_tail_timings(
                f"rows_{acc}_kernel",
                kernel=lambda: rows_tail_sorted(t_k, a_k, sid, order, flat_g, lr),
                update=lambda: rows_tail_adagrad_update(t_k, a_k, c_ids, c_grads, lr),
                apply=lambda: rows_tail_apply(t_k, a_k, uids, gsum, lr),
                dedup=lambda: dedup_rows(flat_ids, flat_g),
                dedup_apply=lambda: rows_tail_apply(t_k, a_k, *dedup_rows(flat_ids, flat_g), lr),
                hot=lambda: rows_tail_adagrad_update(t_k, a_k, hot_ids, hot_grads, lr),
                plain=lambda: rows_tail_sorted_plain(t_p, a_p, sid, order, flat_g, lr),
            ))
            rec["bound_ms"], rec["bound_by"] = tail_bound(m, k, d, a)
            rec["sector_bound_ms"] = tail_sector_bound(m, k, d, a, fused=False)
            rec["apply_bound_ms"] = tail_bound(k, k, d, a)[0]
            rec["hot_K"] = int(torch.unique(hot_ids).numel())
            if acc == "element":
                main = rec
        emit(rec)
    return 0.0, main


def _blank_touched(fused, ids, d: int):
    """``fused`` with the slots of ``ids`` zeroed: what an update of ``ids``
    must leave bitwise unchanged (other slots, pad slots, tail lanes)."""
    from fast_tffm_tpu_torch.ops.packed_table import fused_rows_per_tile, fused_slots

    out = fused.clone()
    p = fused_rows_per_tile(d)
    i = ids.reshape(-1).long().unique()
    fused_slots(out, d)[i // p, i % p] = 0.0
    return out


def phase_fused_tail(rng, train_path: str):
    import numpy as np
    import torch

    from fast_tffm_tpu_torch.ops.packed_table import pack_fused, unpack_fused
    from fast_tffm_tpu_torch.ops.tail import (
        fused_adagrad_plain,
        fused_tail_adagrad_update,
        fused_tail_apply,
        fused_tail_sorted,
        fused_tail_sorted_plain,
        rows_tail_adagrad_update,
    )
    from fast_tffm_tpu_torch.optim import dedup_rows

    vocab, d, lr = 1 << 20, 1 + 8, 0.05
    ids = torch.from_numpy(_first_batch_ids(train_path, vocab)).cuda()
    grads = torch.from_numpy(
        (rng.normal(size=(BATCH, NNZ, d)) * 1e-3).astype(np.float32)).cuda()
    table = torch.from_numpy(rng.uniform(-0.01, 0.01, size=(vocab, d)).astype(np.float32)).cuda()
    accum = torch.from_numpy(rng.uniform(0.1, 0.5, size=(vocab, 1)).astype(np.float32)).cuda()
    fused = pack_fused(table, accum, 0.1)  # 2^20 mod 12 = 4: a partial last tile row
    flat_g = grads.reshape(-1, d)
    sets = {
        "batch": (ids, grads),
        "one id": (ids[:1, :1], grads[:1, :1]),
        "1001 ids": (torch.unique(ids)[:1001].to(torch.int32), flat_g[:1001]),
        "last tile row": (torch.arange(vocab - 4, vocab, dtype=torch.int32, device="cuda"),
                          flat_g[:4]),
        "hot id 0": _padded_batch(ids, grads),
    }
    main = None
    for decay in (1.0, 0.9):
        for which, (c_ids, c_grads) in sets.items():
            got = fused_tail_adagrad_update(fused.clone(), c_ids, c_grads, lr, decay=decay)
            uids, gsum = dedup_rows(c_ids.reshape(-1), c_grads.reshape(-1, d))
            twin = fused_adagrad_plain(fused.clone(), uids, gsum, lr, decay)
            t_r, a_r = table.clone(), accum.clone()
            rows_tail_adagrad_update(t_r, a_r, c_ids, c_grads, lr, decay=decay)
            torch.cuda.synchronize()
            k = int(uids.numel())
            where = f"decay {decay}, {which} (K={k})"
            if not torch.equal(got, twin):
                err = float((got - twin).abs().max())
                fail(f"fused_tail is not bitwise equal to its plain version: {where}, "
                     f"max abs err {err}")
            t_f, a_f = unpack_fused(got, vocab, d)
            if not (torch.equal(t_f, t_r) and torch.equal(a_f, a_r)):
                fail(f"fused_tail unpacked differs from the rows kernel in row mode: {where}")
            if not torch.equal(_blank_touched(got, c_ids, d), _blank_touched(fused, c_ids, d)):
                fail(f"fused_tail changed lanes outside the touched slots: {where}")
            if torch.equal(got, fused):
                fail(f"fused_tail changed nothing: {where}")
            rec = {"phase": "fused_tail", "decay": decay, "ids": which,
                   "M": int(c_ids.numel()), "K": k,
                   "bitwise": True, "bitwise_rows_row": True, "max_abs_err": 0.0}
            if which == "batch" and decay == 1.0:
                flat_ids = c_ids.reshape(-1)
                sid, order = torch.sort(flat_ids, stable=True)
                hot_ids, hot_grads = sets["hot id 0"]
                rec.update(_tail_timings(
                    "fused_slot_kernel",
                    kernel=lambda: fused_tail_sorted(got, sid, order, flat_g, lr),
                    update=lambda: fused_tail_adagrad_update(got, c_ids, c_grads, lr),
                    apply=lambda: fused_tail_apply(got, uids, gsum, lr),
                    dedup=lambda: dedup_rows(flat_ids, flat_g),
                    dedup_apply=lambda: fused_tail_apply(got, *dedup_rows(flat_ids, flat_g), lr),
                    hot=lambda: fused_tail_adagrad_update(got, hot_ids, hot_grads, lr),
                    plain=lambda: fused_tail_sorted_plain(twin, sid, order, flat_g, lr),
                ))
                rec["bound_ms"], rec["bound_by"] = tail_bound(flat_ids.numel(), k, d, 1)
                rec["sector_bound_ms"] = tail_sector_bound(flat_ids.numel(), k, d, 1, fused=True)
                rec["apply_bound_ms"] = tail_bound(k, k, d, 1)[0]
                rec["hot_K"] = int(torch.unique(hot_ids).numel())
                main = rec
            emit(rec)
    return 0.0, main


def _write_checkpoint(path: str, table, accum_width: int, dense=()) -> None:
    """An npz with fast_tffm_tpu/checkpoint.py::_save_npz's members at step
    0: ``table``, Adagrad accumulators of ``accum_width`` at 0.1, and the
    ``dense`` leaves (``dense_{i}``, in the JAX package's order) with
    accumulators at 0.1."""
    import numpy as np

    leaves = {}
    for i, p in enumerate(dense):
        leaves[f"dense_{i}"] = p
        leaves[f"dense_accum_{i}"] = np.full(p.shape, 0.1, np.float32)
    with open(path, "wb") as f:
        np.savez(
            f,
            table=table,
            table_accum=np.full((table.shape[0], accum_width), 0.1, np.float32),
            step=np.int32(0),
            save_id=np.frombuffer(os.path.basename(path).encode(), np.uint8),
            published_at=np.float64(time.time()),
            **leaves,
        )


def _train_once(cfg, device: str, log_to: list, resume: bool = True, step_hook=None,
                entry: str = "train"):
    """``training.train`` (``entry = "dist_train"``: ``training.dist_train``)
    on ``device``, resumed from ``cfg.model_file`` (or from its seeded
    init), its log lines kept; returns (state, seconds)."""
    from fast_tffm_tpu_torch import training

    def log(*a):
        msg = " ".join(str(x) for x in a)
        log_to.append(msg)
        log_stderr(f"[{entry} {device}] {msg}")

    t0 = time.perf_counter()
    state = getattr(training, entry)(cfg, resume=resume, log=log, device=device,
                                      step_hook=step_hook)
    return state, time.perf_counter() - t0


def _logged(lines: list, what: str) -> list[float]:
    """The number after ``what`` in every log line that carries it."""
    out = []
    for line in lines:
        toks = line.split()
        for i, t in enumerate(toks[:-1]):
            if t == what:
                out.append(float(toks[i + 1].replace(",", "")))
    return out


def _update_check(init, card, cpu, rtol: float = UPDATE_RTOL) -> dict:
    """The run's updates (final table minus ``init``) on the card against
    the CPU's, for the bias column and the factor columns apart: the
    relative norm of their difference within ``rtol``, and the count of
    elements they moved within MOVED_RTOL of the CPU's (a path that drops
    the small updates of ordinary rows moves far fewer)."""
    import numpy as np

    out = {}
    for name, cols in (("bias", slice(0, 1)), ("factors", slice(1, None))):
        d_card = card[:, cols].astype(np.float64) - init[:, cols]
        d_cpu = cpu[:, cols].astype(np.float64) - init[:, cols]
        moved = {"cuda": int(np.count_nonzero(d_card)), "cpu": int(np.count_nonzero(d_cpu))}
        norm = float(np.linalg.norm(d_cpu))
        rel = float(np.linalg.norm(d_card - d_cpu)) / norm if norm else float("inf")
        out[name] = {"rel_norm_diff": rel, "moved": moved, "max_abs_update": float(np.abs(d_cpu).max())}
        if not (moved["cpu"] and rel <= rtol
                and abs(moved["cuda"] - moved["cpu"]) <= MOVED_RTOL * moved["cpu"]):
            fail(f"the card's {name} updates differ from the CPU run's: {out[name]}")
    return out


def _gradient_check(model, table, batch) -> dict:
    """The order-3 gradient of the training loss with respect to the
    gathered rows, on the card (forward and backward kernels) and on the
    CPU (their plain versions), from one table: within 1e-5 of the largest
    gradient, and non-zero in the factor columns."""
    import torch

    from fast_tffm_tpu_torch.trainer import batch_loss

    grads = []
    for dev in ("cuda", "cpu"):
        b = batch.to(dev)
        rows = table.to(dev)[b.ids].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(batch_loss(model, rows, [], b)[0], rows)
        grads.append(g.cpu())
    scale = float(grads[1].abs().max())
    err = float((grads[0] - grads[1]).abs().max())
    factor_max = float(grads[0][..., 1:].abs().max())
    if not err <= RTOL * scale or factor_max == 0.0:
        fail(f"order-3 gradient on the card differs from the CPU's: max abs err {err} "
             f"against a largest gradient of {scale}; factor columns max {factor_max}")
    return {"max_abs_err": err, "max_abs_grad": scale, "factor_max_abs_grad": factor_max}


def _seeded_init(rng, tmp: str, name: str, base, model, fused: bool):
    """The initial state of a training phase, as an npz: factors U(±0.01)
    from the seed, zero bias, element accumulators (rows) or a [V, 1] row
    accumulator (fused); a DeepFM's MLP He-initialised from the seed, zero
    biases.  Returns (table, dense leaves, path)."""
    import numpy as np

    table = np.zeros((base.vocabulary_size, model.row_dim), np.float32)
    table[:, 1:] = rng.uniform(-0.01, 0.01, (base.vocabulary_size, model.row_dim - 1))
    dense = []
    if model.dense_names:
        dims = (model.num_fields * model.factor_num, *model.hidden_dims, 1)
        leaves = {}
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            leaves[f"w{i}"] = (rng.normal(size=(d_in, d_out)) * np.sqrt(2.0 / d_in)).astype(
                np.float32)
            leaves[f"b{i}"] = np.zeros(d_out, np.float32)
        dense = [leaves[n] for n in model.dense_names]
    init = os.path.join(tmp, f"{name}.init.ckpt")
    _write_checkpoint(init, table, 1 if fused else model.row_dim, dense)
    return table, dense, init


def _phase_cfg(base, tmp: str, name: str, device: str, init: str, **kw):
    """``base`` for one run of a phase: its own copy of the initial npz."""
    import dataclasses
    import shutil

    model_file = os.path.join(tmp, f"{name}.{device}.ckpt")
    shutil.copy(init, model_file)
    return dataclasses.replace(
        base, model_file=model_file, score_path=os.path.join(tmp, f"{name}.{device}.scores"),
        **kw,
    ).validate()


def _wrapper_counts() -> dict:
    from fast_tffm_tpu_torch.serving.replica import launch_counts

    return launch_counts()


def _zero_counters() -> None:
    from fast_tffm_tpu_torch.ops.anova import anova_inter, anova_inter_bwd
    from fast_tffm_tpu_torch.ops.dcn import dcn_cross_bwd, dcn_cross_fwd
    from fast_tffm_tpu_torch.ops.fm import fm2_score_bwd, fm2_score_fwd
    from fast_tffm_tpu_torch.ops.tail import fused_tail_adagrad_update, rows_tail_adagrad_update

    anova_inter.launches = anova_inter_bwd.launches = 0
    rows_tail_adagrad_update.launches = fused_tail_adagrad_update.launches = 0
    fm2_score_fwd.launches = fm2_score_bwd.launches = 0
    dcn_cross_fwd.launches = dcn_cross_bwd.launches = 0


def _launches_match(launches: dict, want: dict) -> bool:
    """Whether a run launched each kernel as often as ``want`` says (0 where
    it says nothing).  A forward that ``want`` names may have launched more:
    validation and prediction score through the same forward kernel."""
    return all(launches[k] >= want[k] if k in FORWARD_OF.values() and want.get(k)
               else launches[k] == want.get(k, 0) for k in KERNELS)


def _trace_agrees(traced, counts, graphed: bool) -> bool:
    """Whether a run's trace holds every launch: an eager run's (every
    launch passes a wrapper) equals the wrappers' counts; a graphed run's
    holds at least the wrappers' launches, and its replays (trace less
    wrappers) one forward per backward of each pair and one pair per tail,
    as every replayed step makes (order 3: the ANOVA pair; order 2 and
    DeepFM: the fm2_score pair; FFM: a tail alone)."""
    if not graphed:
        return traced == counts
    replays = {k: traced[k] - counts[k] for k in KERNELS}
    tails = replays["rows_tail_adagrad"] + replays["fused_tail_adagrad"]
    return (min(replays.values()) >= 0
            and all(replays[fwd] == replays[bwd] for bwd, fwd in FORWARD_OF.items())
            and sum(replays[bwd] for bwd in FORWARD_OF) in (0, tails))


def _counted_run(run_once, what: str, graphed) -> tuple[dict, dict]:
    """``run_once()`` under ``traced_window``, every wrapper counter zeroed
    just before and read just after.  A trace that comes back without
    kernel events, or whose counts do not agree with the wrappers'
    (``_trace_agrees``; ``graphed()`` says which rule: the profiler lost
    events), is run again with a fresh ``run_once()``, twice at most;
    ``_step_launches`` holds the last attempt.  Returns (the window, with
    its ``trace_attempts``, and the wrappers' counts)."""
    for attempt in range(1, 4):
        _zero_counters()
        window = traced_window(run_once)
        counts = _wrapper_counts()
        window["trace_attempts"] = attempt
        traced = window["launches_traced"]
        if traced is not None and _trace_agrees(traced, counts, graphed()):
            return window, counts
        log_stderr(f"{what}: the profiler trace counts {traced} kernel launches, the "
                   f"wrappers {counts}; running it again.  The traced launches in order: "
                   + " ".join(f"{k}@{ts - _LAST_TRACE[0][0]:.0f}" for ts, k in _LAST_TRACE))
    if window["launches_traced"] is None:
        fail(f"{what}: three profiler traces without kernel events: launches not measured")
    return window, counts


def _step_launches(window: dict, wrappers: dict, graphed: bool, what: str) -> dict:
    """The kernel launches a run's train steps made.  Eager steps launch
    through the wrappers, whose counts the trace must equal.  A graphed
    run's steps are CUDA-graph replays, which never pass through a
    wrapper: their launches are the trace's counts less the wrappers'
    (the capture's warm-up on a scratch state, and validation), one
    forward per backward.

    In a long process the profiler has dropped one kernel event of a
    run, the same one in every attempt: the run's first forward launch
    (its trace opens with the first step's backward; in a graphed run the
    capture warm-up's), which the wrapper counted and the run's results
    (bitwise resumes, card against CPU) show ran.  A run that opens with
    eager validation forwards (a resumed run's end-of-epoch validation)
    has lost one of them the same way: the trace opens with a forward, and
    every backward in it still has its forward just before it.  Those
    patterns, and no other, pass after ``_counted_run``'s three attempts:
    exactly one forward event short (anova_fwd or fm2_fwd), every other
    kernel's count as it must be, and either the trace's first kernel of
    KERNELS not a forward or no backward without its forward.  The run
    keeps the wrappers' counts (graphed: its replays' forwards are its
    backwards' count) and its window records ``trace_lost_events``.  Any
    other difference fails."""
    traced = window["launches_traced"]
    if _trace_agrees(traced, wrappers, graphed):
        return ({k: traced[k] - wrappers[k] for k in KERNELS} if graphed else dict(wrappers))
    lost_eager = (window["first_traced"] not in FORWARD_OF.values()
                  or window["bwd_without_fwd"] == 0)
    shorts = [(fwd, dict(traced, **{fwd: traced[fwd] + 1})) for fwd in FORWARD_OF.values()]
    lost = [(fwd, short) for fwd, short in shorts if _trace_agrees(short, wrappers, graphed)]
    if window["trace_attempts"] < 3 or not lost_eager or not lost:
        fail(f"{what}: the trace counts {traced} kernel launches, the wrappers {wrappers} "
             f"(graphed: {graphed}; first traced: {window['first_traced']})")
    fwd, short = lost[0]
    window["trace_lost_events"] = {fwd: 1}
    log_stderr(f"{what}: the trace lost one eager forward launch in every attempt; "
               "keeping the wrappers' counts")
    return {k: short[k] - wrappers[k] for k in KERNELS} if graphed else dict(wrappers)


def _dense_check(init, card, cpu, rtol: float) -> dict:
    """A DeepFM run's dense leaves and accumulators on the card against the
    CPU's, leaf by leaf: the norm of the difference of their updates (final
    minus ``init``; the accumulators' from 0.1) within ``rtol`` of the CPU
    update's norm, plus TABLE_ATOL per element (an accumulator whose g²
    stays below half a float32 step of 0.1 never moves on either device),
    and their largest elementwise difference."""
    import numpy as np

    out = {}
    for what, leaves, start in (("dense", zip(card.dense, cpu.dense), init),
                                ("dense_accum", zip(card.dense_accum, cpu.dense_accum),
                                 [np.full(p.shape, 0.1, np.float32) for p in init])):
        rels, errs, ok = [], [], True
        for (a, b), p0 in zip(leaves, start):
            d_card = a.cpu().numpy().astype(np.float64) - p0
            d_cpu = b.numpy().astype(np.float64) - p0
            norm, diff = float(np.linalg.norm(d_cpu)), float(np.linalg.norm(d_card - d_cpu))
            rels.append(diff / norm if norm else (0.0 if diff == 0.0 else float("inf")))
            errs.append(float(np.abs(d_card - d_cpu).max()))
            ok = ok and diff <= rtol * norm + TABLE_ATOL * np.sqrt(d_cpu.size)
        out[what] = {"rel_norm_diff": rels, "max_abs_diff": errs}
        if not ok:
            fail(f"the card's {what} updates differ from the CPU run's: {out[what]}")
    return out


def _mlp_gradient_check(model, state, batch, rtol: float | None = None) -> dict:
    """One step's gradients of a DeepFM's (or DCN-V2's) training loss, with
    respect to the gathered rows and to each dense leaf, on the card and on
    the CPU from one state: within ``rtol`` (by default MLP_GRAD_RTOL of the
    compute dtype) by relative norm."""
    import torch

    from fast_tffm_tpu_torch.trainer import batch_loss

    grads = {}
    for dev in ("cuda", "cpu"):
        b = batch.to(dev)
        rows = state.table.to(dev)[b.ids.long()].detach().requires_grad_(True)
        dense = [p.to(dev).detach().requires_grad_(True) for p in state.dense]
        g = torch.autograd.grad(batch_loss(model, rows, dense, b)[0], [rows, *dense])
        grads[dev] = [x.cpu().double() for x in g]
    rels = [float((a - b).norm() / b.norm()) for a, b in zip(grads["cuda"], grads["cpu"])]
    rtol = MLP_GRAD_RTOL[model.compute_dtype] if rtol is None else rtol
    if not max(rels) <= rtol:
        fail(f"the {type(model).__name__} gradients on the card differ from the CPU's by {rels} "
             f"(rtol {rtol})")
    return {"rel_norm_diff": {"rows": rels[0], **dict(zip(model.dense_names, rels[1:]))},
            "rtol": rtol}


def _card_and_cpu(name: str, cfg_for, model, table, steps: int, fused: bool,
                  expect: dict | None = None, dense=()) -> dict:
    """The main path: ``training.train`` on the card under the profiler,
    every kernel counter zeroed just before and read just after; then the
    same run on the CPU.  Fails unless the path launched each kernel
    ``expect`` names that many times and no other (``_launches_match``: a
    forward it names at least that many; ``expect`` None, the FM of order
    3: both ANOVA kernels and its tail once per step, the other tail and
    the order-2 pair never), the losses are finite, the card's final table and
    accumulators are within TABLE_ATOL of the CPU's, the updates agree
    (``_update_check``) and the validation AUCs within AUC_TOL.  A DeepFM
    (``dense``, its initial leaves) is held by its updates instead, the
    table's and the MLP's (``_dense_check``), within MLP_DRIFT_RTOL.  Returns the record and the
    live card state."""
    import numpy as np

    from fast_tffm_tpu_torch.trainer import unpack_state

    tail = "fused_tail_adagrad" if fused else "rows_tail_adagrad"
    other = "rows_tail_adagrad" if fused else "fused_tail_adagrad"
    attempts, result = [], {}

    def run_once():
        cfg, lines = cfg_for("cuda"), []
        attempts.append(lines)
        result["cfg"] = cfg
        result["state"] = _train_once(cfg, "cuda", lines)[0]

    run, wrappers = _counted_run(run_once, name, lambda: result["cfg"].steps_per_call > 1)
    cuda_cfg, cuda_log = result["cfg"], attempts[-1]
    graphed = cuda_cfg.steps_per_call > 1
    stepped = _step_launches(run, wrappers, graphed, name)
    if expect is None:
        launches = {k: stepped[k] for k in ("anova_fwd", "anova_bwd", tail)}
        if launches["anova_fwd"] < steps or launches["anova_bwd"] != steps:
            fail(f"the {name} path did not launch both ANOVA kernels once per step: {launches}")
        if launches[tail] != steps or run["launches_traced"][other]:
            fail(f"the {tail} kernel ran {launches[tail]} times for {steps} steps "
                 f"(the other tail {run['launches_traced'][other]} times)")
        if stepped["fm2_fwd"] or stepped["fm2_bwd"]:
            fail(f"the order-3 {name} path launched the order-2 pair: {stepped}")
    else:
        launches = dict(stepped)
        if not _launches_match(stepped, expect):
            fail(f"the {name} path launched {stepped} for {steps} steps, expected {expect}")
    losses = _logged(cuda_log, "loss")
    if not losses or not all(np.isfinite(losses)):
        fail(f"non-finite or missing training losses on the card: {losses}")
    cuda_state, cuda_s = unpack_state(result["state"], model), run["wall_ms"] / 1e3

    cpu_log = []
    cpu_state, cpu_s = _train_once(cfg_for("cpu"), "cpu", cpu_log)
    cpu_state = unpack_state(cpu_state, model)
    table_err = float((cuda_state.table.cpu() - cpu_state.table).abs().max())
    accum_err = float((cuda_state.table_accum.cpu() - cpu_state.table_accum).abs().max())
    if not dense and not (table_err <= TABLE_ATOL and accum_err <= TABLE_ATOL):
        fail(f"{name}: the card's trained table and accumulators differ from the CPU "
             f"run's by {table_err} and {accum_err}")
    rtol = MLP_DRIFT_RTOL if dense else UPDATE_RTOL
    updates = _update_check(table, cuda_state.table.cpu().numpy(), cpu_state.table.numpy(), rtol)
    if dense:
        updates.update(_dense_check(dense, cuda_state, cpu_state, rtol))
    auc_cuda, auc_cpu = _logged(cuda_log, "auc"), _logged(cpu_log, "auc")
    if not (auc_cuda and auc_cpu and abs(auc_cuda[-1] - auc_cpu[-1]) <= AUC_TOL
            and auc_cuda[-1] > 0.5):
        fail(f"{name}: validation AUC on the card {auc_cuda} against the CPU's {auc_cpu}")
    batch = cuda_cfg.batch_size
    return {
        "rec": {
            "steps": steps,
            "batch_size": batch,
            "launches": launches,
            "launches_by_wrappers": wrappers,
            "launches_traced": run["launches_traced"],
            "losses": losses,
            "examples_per_s_logged": _logged(cuda_log, "examples/sec"),
            "examples_per_s_run": steps * batch / cuda_s,
            "seconds": {"cuda": cuda_s, "cpu": cpu_s},
            "validation_auc": {"cuda": auc_cuda[-1], "cpu": auc_cpu[-1]},
            "max_abs_table_diff": table_err,
            "max_abs_accum_diff": accum_err,
            "updates_rtol": rtol,
            "updates": updates,
            "traced_run": run,
        },
        "cuda_cfg": cuda_cfg,
        "cuda_log": cuda_log,
        "cuda_logs_all": [m for lines in attempts for m in lines],
        "state": result["state"],
        "cpu_state": cpu_state,
    }


def _step_times(fn, reps: int = 12, per_call: int = 1) -> list[float]:
    """Sorted wall ms per step of ``fn`` (``per_call`` steps a call), each
    call ended by a synchronize, the first two calls dropped."""
    import torch

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / per_call)
    return sorted(times[2:])


def phase_train(rng, tmp: str, train_path: str, valid_path: str, fused: bool = False):
    """The rows run (``fused`` False) or the fused lane-packed run of
    baseline5, on the card and then on the CPU from one seeded npz."""
    import dataclasses

    from fast_tffm_tpu_torch.config import build_model, load_config
    from fast_tffm_tpu_torch.data.pipeline import batch_stream
    from fast_tffm_tpu_torch.models.base import Batch
    from fast_tffm_tpu_torch.trainer import make_packed_train_step, make_train_step

    name = "train_fused" if fused else "train"
    base = load_config(os.path.join(HERE, CONFIG))
    if fused:
        base = dataclasses.replace(base, **FUSED).validate()
    model = build_model(base)
    table, _, init = _seeded_init(rng, tmp, name, base, model, fused)
    out = _card_and_cpu(
        name,
        lambda device: _phase_cfg(base, tmp, name, device, init, train_files=(train_path,),
                                  validation_files=(valid_path,), predict_files=(valid_path,),
                                  log_every=4),
        model, table, TRAIN_BATCHES, fused,
    )
    parsed, w = next(batch_stream([valid_path], batch_size=BATCH,
                                  vocabulary_size=base.vocabulary_size, max_nnz=NNZ))
    host_batch = Batch.from_parsed(parsed, w)
    # The repaired gradient, on a validation batch, from the CPU run's table.
    grad = None if fused else _gradient_check(model, out["cpu_state"].table, host_batch)

    # Step time on the card with the input already there; then one traced step.
    step = (make_packed_train_step if fused else make_train_step)(model, base.learning_rate)
    state, batch = out["state"], host_batch.to("cuda")
    times = _step_times(lambda: step(state, batch))
    emit({
        "phase": name,
        "config": CONFIG + (" + " + json.dumps(FUSED) if fused else ""),
        "thread_num": base.thread_num,
        **out["rec"],
        "step_ms_p50": times[len(times) // 2],
        "step_ms_min": times[0],
        "step_examples_per_s": BATCH / (times[len(times) // 2] / 1e3),
        "gradient": grad,
        "traced_step": traced_window(lambda: step(state, batch)),
    })
    return out["cuda_cfg"], out["rec"]["launches"]


def phase_parse(train_path: str):
    """The 24-batch train file through the native stream at the config's
    thread_num and at 0 (every usable core), and through the Python stream:
    every batch bitwise equal, rows/s of each."""
    import numpy as np

    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data.native import best_parser, native_batch_stream, usable_cores
    from fast_tffm_tpu_torch.data.pipeline import batch_stream

    cfg = load_config(os.path.join(HERE, CONFIG))
    kw = dict(batch_size=BATCH, vocabulary_size=cfg.vocabulary_size,
              hash_feature_id=cfg.hash_feature_id, max_nnz=NNZ)
    runs = {}
    for threads in (cfg.thread_num, 0):
        parser = best_parser(threads)
        runs[f"native_threads_{threads}"] = (
            parser.threads, lambda p=parser: native_batch_stream(p, [train_path], **kw))
    runs["python"] = (1, lambda: batch_stream([train_path], **kw))
    out, batches = {}, {}
    for name, (threads, make) in runs.items():
        t0 = time.perf_counter()
        batches[name] = list(make())
        dt = time.perf_counter() - t0
        out[name] = {"threads": threads, "seconds": dt, "rows_per_s": TRAIN_BATCHES * BATCH / dt}
    want = batches["python"]
    for name, got in batches.items():
        if len(got) != len(want) or len(got) != TRAIN_BATCHES:
            fail(f"parse: {name} gave {len(got)} batches, python {len(want)}")
        for (p, w), (q, v) in zip(got, want):
            same = np.array_equal(w, v) and all(
                np.array_equal(getattr(p, f).astype(np.int64) if f == "ids" else getattr(p, f),
                               getattr(q, f).astype(np.int64) if f == "ids" else getattr(q, f))
                for f in ("labels", "ids", "vals", "fields", "nnz"))
            if not same:
                fail(f"parse: {name}'s batches are not bitwise the Python parser's")
    emit({"phase": "parse", "rows": TRAIN_BATCHES * BATCH, "bitwise": True,
          "host_cores": os.cpu_count(), "usable_cores": usable_cores(), **out})


def phase_train_fmb(rng, tmp: str, train_path: str, valid_path: str):
    """baseline5 with binary_cache and shuffle, rows layout, 2 epochs on the
    card and on the CPU (``_card_and_cpu``'s checks); then a second card
    run, which must reuse the cache the first built."""
    import dataclasses

    from fast_tffm_tpu_torch.config import build_model, load_config

    name, kw = "train_fmb", {"binary_cache": True, "shuffle": True}
    base = dataclasses.replace(load_config(os.path.join(HERE, CONFIG)), **kw)
    model = build_model(base)
    table, _, init = _seeded_init(rng, tmp, name, base, model, False)
    files = dict(train_files=(train_path,), validation_files=(valid_path,), epoch_num=2,
                 log_every=8)
    out = _card_and_cpu(name, lambda device: _phase_cfg(base, tmp, name, device, init, **files),
                        model, table, 2 * TRAIN_BATCHES, False)
    # The first run builds the train and the validation file's caches.
    built = [m for m in out["cuda_logs_all"] if m.startswith("building binary cache")]
    again = []
    t0 = time.perf_counter()
    _train_once(_phase_cfg(base, tmp, name, "cuda2", init, **files), "cuda", again)
    rebuilt = [m for m in again if m.startswith("building binary cache")]
    if len(built) != 2 or rebuilt:
        fail(f"train_fmb: {len(built)} caches built by the first run and {len(rebuilt)} "
             "by the second (expected 2 and 0)")
    emit({"phase": name, "config": CONFIG + " + " + json.dumps(kw), **out["rec"],
          "caches_built": built, "second_run": {
              "cache_reused": True, "seconds": time.perf_counter() - t0,
              "examples_per_s_logged": _logged(again, "examples/sec")}})


def phase_train_cached(rng, tmp: str, train_path: str, valid_path: str, fused: bool):
    """device_cache + shuffle + steps_per_call = 8 for 2 epochs: the card
    (CUDA-graph replays) against the CPU (``_card_and_cpu``), and bitwise
    against the card's own K = 1 run from the same npz and cache; the graph's
    step time against the eager K = 1 step's, and a traced replay."""
    import dataclasses

    import torch

    from fast_tffm_tpu_torch.config import build_model, load_config
    from fast_tffm_tpu_torch.data.binary import ensure_fmb_cache
    from fast_tffm_tpu_torch.data.device_cache import (
        epoch_index_chunks,
        load_device_dataset,
        make_cached_scan_train_step,
        make_cached_train_step,
    )
    from fast_tffm_tpu_torch.trainer import packed_train_step_body, train_step_body, unpack_state

    name = "train_cached_fused" if fused else "train_cached"
    kw = {"device_cache": True, "binary_cache": True, "shuffle": True, "steps_per_call": 8}
    base = load_config(os.path.join(HERE, CONFIG))
    base = dataclasses.replace(base, **kw, **(FUSED if fused else {})).validate()
    model = build_model(base)
    table, _, init = _seeded_init(rng, tmp, name, base, model, fused)
    files = dict(train_files=(train_path,), validation_files=(valid_path,), epoch_num=2,
                 log_every=8)
    out = _card_and_cpu(name, lambda device: _phase_cfg(base, tmp, name, device, init, **files),
                        model, table, 2 * TRAIN_BATCHES, fused)
    one_log = []
    one, _ = _train_once(_phase_cfg(base, tmp, name, "cuda_k1", init, steps_per_call=1, **files),
                         "cuda", one_log)
    k8, k1 = unpack_state(out["state"], model), unpack_state(one, model)
    if not (torch.equal(k8.table, k1.table) and torch.equal(k8.table_accum, k1.table_accum)
            and k8.step == k1.step):
        err = float((k8.table - k1.table).abs().max())
        fail(f"{name}: steps_per_call = 8 is not bitwise the card's K = 1 run (table {err})")
    if _logged(one_log, "auc") != _logged(out["cuda_log"], "auc"):
        fail(f"{name}: validation AUC of K = 8 and K = 1 differ")

    # Step times: one replay of 8 steps against 8 eager K = 1 steps, on the
    # resident epoch, continuing from the trained state.
    cfg = out["cuda_cfg"]
    data = load_device_dataset(
        ensure_fmb_cache(cfg.train_files, vocabulary_size=cfg.vocabulary_size, max_nnz=NNZ,
                         log=log_stderr),
        batch_size=BATCH, vocabulary_size=cfg.vocabulary_size, max_nnz=NNZ, device="cuda")
    body = (lambda m, lr, st, b: packed_train_step_body(m, lr, st, b)) if fused else train_step_body
    scan, _ = make_cached_scan_train_step(model, cfg.learning_rate, data, body)
    eager, _ = make_cached_train_step(model, cfg.learning_rate, data, body)
    state, idxs = out["state"], epoch_index_chunks(data.batches, 8, "cuda")[0]
    index = torch.tensor(0, dtype=torch.int64, device="cuda")
    graph_ms = _step_times(lambda: scan(state, idxs), per_call=8)
    eager_ms = _step_times(lambda: eager(state, index))
    replay = traced_window(lambda: scan(state, idxs))
    single = traced_window(lambda: eager(state, index))
    emit({
        "phase": name,
        "config": CONFIG + " + " + json.dumps({**kw, **(FUSED if fused else {})}),
        **out["rec"],
        "bitwise_k1": True,
        "graph_step_ms_p50": graph_ms[len(graph_ms) // 2],
        "eager_step_ms_p50": eager_ms[len(eager_ms) // 2],
        "graph_busy_ms_per_step": None if replay["device_busy_ms"] is None
        else replay["device_busy_ms"] / 8,
        "eager_busy_ms_per_step": single["device_busy_ms"],
        "traced_replay": replay,
        "traced_eager_step": single,
    })
    return out["rec"]["launches"]


def phase_throughput(tmp: str, big_path: str):
    """The config's 1,048,576-row epoch on the card only: streamed through
    the native parser, from FMB (the cache built first, its time apart) as
    configured and on arrays, the same with steps_per_call = 8 (the
    streamed K-step graph), and device-cached with steps_per_call = 8; ex/s
    (the logged windows and the whole run) and the card's idle share of
    each run."""
    import dataclasses

    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data.binary import ensure_fmb_cache
    from fast_tffm_tpu_torch.data.native import best_parser

    base = dataclasses.replace(
        load_config(os.path.join(HERE, CONFIG)), train_files=(big_path,), validation_files=(),
        predict_files=(), save_every_epochs=0,
    )
    t0 = time.perf_counter()
    ensure_fmb_cache((big_path,), vocabulary_size=base.vocabulary_size, max_nnz=NNZ,
                     parser=best_parser(base.thread_num), log=log_stderr)
    convert_s = time.perf_counter() - t0
    rec = {"phase": "throughput", "rows": THROUGHPUT_BATCHES * BATCH, "config": CONFIG,
           "fmb_convert_seconds": convert_s}
    # fmb_k8 ships on the packed wire (the default at K > 1), fmb_k8_arrays
    # is its twin in the same call; fmb and fmb_arrays both convert in the
    # loop (K = 1), so their gap is the call's run-to-run spread.
    for mode, kw in (("streamed_native", {}), ("fmb", {"binary_cache": True}),
                     ("fmb_arrays", {"binary_cache": True, "wire_format": "arrays"}),
                     ("fmb_k8", {"binary_cache": True, "steps_per_call": 8}),
                     ("fmb_k8_arrays", {"binary_cache": True, "steps_per_call": 8,
                                        "wire_format": "arrays"}),
                     ("device_cached_k8", {"binary_cache": True, "device_cache": True,
                                           "steps_per_call": 8})):
        cfg = dataclasses.replace(base, model_file=os.path.join(tmp, f"tp.{mode}.ckpt"),
                                  **kw).validate()
        attempts = []

        def run_once(cfg=cfg):
            attempts.append([])
            _train_once(cfg, "cuda", attempts[-1], resume=False)

        run, wrappers = _counted_run(run_once, f"throughput {mode}",
                                     lambda cfg=cfg: cfg.steps_per_call > 1)
        lines = attempts[-1]
        stepped = _step_launches(run, wrappers, cfg.steps_per_call > 1, f"throughput {mode}")
        if any(stepped[k] != THROUGHPUT_BATCHES
               for k in ("anova_fwd", "anova_bwd", "rows_tail_adagrad")):
            fail(f"throughput {mode}: {stepped} kernel launches for {THROUGHPUT_BATCHES} steps")
        logged = _logged(lines, "examples/sec")
        rec[mode] = {
            **kw,
            "examples_per_s_logged": logged,
            "examples_per_s_logged_median": sorted(logged)[len(logged) // 2] if logged else None,
            "examples_per_s_run": THROUGHPUT_BATCHES * BATCH / (run["wall_ms"] / 1e3),
            "device_idle_share": run["device_idle_share"],
            "device_busy_ms": run["device_busy_ms"],
            "wall_ms": run["wall_ms"],
            "launches": stepped,
        }
    emit(rec)


def phase_predict(cuda_cfg, name: str = "predict", rows: int = VALID_BATCHES * BATCH,
                  anova: bool = True, atol: float = ATOL):
    """prediction.predict of a trained model on the card and on the CPU:
    ``rows`` finite printed scores within ``atol`` of each other; the
    forward ANOVA kernel launched on the
    card for an FM of order >= 3 (``anova``), and never for the others."""
    import dataclasses

    import numpy as np

    from fast_tffm_tpu_torch.ops.anova import anova_inter
    from fast_tffm_tpu_torch.prediction import predict

    paths, seconds = {}, {}
    for device in ("cuda", "cpu"):
        cfg = dataclasses.replace(cuda_cfg, score_path=f"{cuda_cfg.score_path}.{device}")
        anova_inter.launches = 0
        t0 = time.perf_counter()
        predict(cfg, log=log_stderr, device=device)
        seconds[device] = time.perf_counter() - t0
        if device == "cuda" and (anova_inter.launches > 0) != anova:
            fail(f"{name} on cuda launched the anova_fwd kernel {anova_inter.launches} times")
        paths[device] = cfg.score_path
    got, want = np.loadtxt(paths["cuda"]), np.loadtxt(paths["cpu"])
    if got.shape != (rows,) or not np.isfinite(got).all():
        fail(f"{name} wrote {got.shape} scores, expected {rows} finite")
    err = float(np.abs(got - want).max())
    # %.6f scores: the card's and the CPU's printed values may differ by one
    # decimal step where the unrounded scores straddle a rounding boundary.
    if err > atol + 1e-9:
        fail(f"{name} scores on the card differ from the CPU's by {err}")
    emit({"phase": name, "table_layout": cuda_cfg.table_layout, "model": cuda_cfg.model,
          "scores": int(got.shape[0]), "max_abs_err_printed": err, "atol": atol,
          "seconds": seconds})


def _lines(rng, n: int, vocab: int) -> list[str]:
    ids = rng.integers(0, vocab, size=(n, NNZ))
    vals = 1.0 - rng.random((n, NNZ))  # (0, 1]
    labels = rng.integers(0, 2, size=n)
    return [
        f"{labels[i]} " + " ".join(f"{ids[i, j]}:{vals[i, j]:.6f}" for j in range(NNZ))
        for i in range(n)
    ]


def phase_serve(rng, tmp: str):
    import dataclasses

    import numpy as np
    import torch

    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data.libsvm import parse_lines
    from fast_tffm_tpu_torch.models.base import Batch
    from fast_tffm_tpu_torch.ops.anova import anova_inter
    from fast_tffm_tpu_torch.prediction import load_scoring_state, make_score_fn
    from fast_tffm_tpu_torch.serving import serve_lines

    cfg = load_config(os.path.join(HERE, CONFIG))
    # Random factors and non-zero biases from the seed.
    table = np.empty((cfg.vocabulary_size, 1 + cfg.factor_num), np.float32)
    table[:, 0] = rng.uniform(-0.1, 0.1, cfg.vocabulary_size)
    table[:, 1:] = rng.uniform(-0.25, 0.25, (cfg.vocabulary_size, cfg.factor_num))
    model_file = os.path.join(tmp, "baseline5.serve.ckpt")
    _write_checkpoint(model_file, table, 1)
    cfg = dataclasses.replace(cfg, model_file=model_file)
    lines = _lines(rng, SERVE_LINES, cfg.vocabulary_size)

    out = io.StringIO()
    anova_inter.launches = 0
    t0 = time.perf_counter()
    snap = serve_lines(cfg, lines, out=out, log=log_stderr, device="cuda")
    serve_s = time.perf_counter() - t0
    launches = anova_inter.launches
    if launches == 0:
        fail("the serving path never launched the anova_fwd kernel")

    printed = np.array([float(s) for s in out.getvalue().split()], np.float64)
    if printed.shape != (SERVE_LINES,) or not np.isfinite(printed).all():
        fail(f"serve_lines returned {printed.shape[0]} scores (finite: "
             f"{bool(np.isfinite(printed).all())}), expected {SERVE_LINES} finite")

    # The port's own CPU path (plain versions) on the same table and lines.
    parsed = parse_lines(lines, vocabulary_size=cfg.vocabulary_size, max_nnz=NNZ)
    batch = Batch.from_parsed(parsed)
    quiet = lambda *_: None  # noqa: E731
    model, cpu_state = load_scoring_state(cfg, quiet, device="cpu")
    want = make_score_fn(cfg, cpu_state, NNZ, model=model)(cpu_state, batch).numpy()
    # serve_lines prints %.6f: the printed score must be the CPU score's
    # printed value or its decimal neighbour (a difference within atol).
    printed_cpu = np.array([float(f"{s:.6f}") for s in want], np.float64)
    printed_err = float(np.abs(printed - printed_cpu).max())
    if printed_err > ATOL + 1e-9:
        fail(f"served scores differ from the CPU path by {printed_err} (> {ATOL})")
    # Unrounded: the same rows scored on the card against the CPU path.
    _, gpu_state = load_scoring_state(cfg, quiet, device="cuda")
    got = make_score_fn(cfg, gpu_state, NNZ, model=model)(gpu_state, batch.to("cuda")).cpu().numpy()
    raw_err = float(np.abs(got - want).max())
    if raw_err > ATOL:
        fail(f"card scores differ from the CPU path by {raw_err} (> {ATOL})")
    torch.cuda.synchronize()

    # The same table and lines served under table_layout = packed.
    packed_cfg = dataclasses.replace(cfg, **FUSED).validate()
    packed_out = io.StringIO()
    anova_inter.launches = 0
    t0 = time.perf_counter()
    serve_lines(packed_cfg, lines, out=packed_out, log=log_stderr, device="cuda")
    packed_s = time.perf_counter() - t0
    packed_printed = np.array([float(s) for s in packed_out.getvalue().split()], np.float64)
    if packed_printed.shape != (SERVE_LINES,) or anova_inter.launches == 0:
        fail(f"packed serving returned {packed_printed.shape[0]} scores with "
             f"{anova_inter.launches} anova_fwd launches")
    packed_err = float(np.abs(packed_printed - printed).max())
    if packed_err > ATOL + 1e-9:
        fail(f"packed serving differs from the rows config's scores by {packed_err}")
    _, packed_state = load_scoring_state(packed_cfg, quiet, device="cuda")
    got = make_score_fn(packed_cfg, packed_state, NNZ, model=model)(
        packed_state, batch.to("cuda")).cpu().numpy()
    packed_raw_err = float(np.abs(got - want).max())
    if packed_state.layout != "packed" or packed_raw_err > ATOL:
        fail(f"packed card scores differ from the CPU path by {packed_raw_err} "
             f"(layout {packed_state.layout})")

    total = snap["total_ms"]
    emit({
        "phase": "serve",
        "config": CONFIG,
        "vocabulary_size": cfg.vocabulary_size,
        "row_dim": 1 + cfg.factor_num,
        "lines": SERVE_LINES,
        "seconds": serve_s,
        "lines_per_s": SERVE_LINES / serve_s,
        "p50_total_ms": total.get("p50"),
        "p99_total_ms": total.get("p99"),
        "compute_ms": snap["compute_ms"],
        "batch_occupancy": snap["batch_occupancy"],
        "bucket_rows": snap["bucket_rows"],
        "flushes": snap["flushes"],
        "anova_launches": launches,
        "max_abs_err_printed": printed_err,
        "max_abs_err_raw": raw_err,
        "packed": {"table_layout": "packed", "seconds": packed_s,
                   "max_abs_err_printed_vs_rows": packed_err,
                   "max_abs_err_raw": packed_raw_err},
        # A second pass under the profiler: how much of the wall time the
        # card was busy.
        "traced_pass": traced_window(
            lambda: serve_lines(cfg, lines, out=io.StringIO(), log=quiet, device="cuda")
        ),
    })


def _zoo_base(key: str):
    from fast_tffm_tpu_torch.config import build_model, load_config

    config, data = ZOO[key]
    base = load_config(os.path.join(HERE, config))
    return config, data, base, build_model(base)


def _score_atol(cfg) -> float:
    return BF16_SCORE_ATOL if cfg.compute_dtype == "bfloat16" else ATOL


def _mlp_route(model, state, batch) -> dict:
    """DeepFM's MLP at the training batch on the card: the route the port
    takes (a float32 product over operands rounded to bfloat16, TF32 off:
    the float32 pre-activations of JAX's bf16 dot with
    preferred_element_type=float32), its forward and forward + backward
    time, and its bound at the float32 rate.  Beside it, measured only:
    whether this torch has aten::mm.dtype (bf16 operands on the tensor
    cores, a float32 output), its time on the first layer, and whether
    autograd has a backward for it."""
    import torch

    from fast_tffm_tpu_torch.models.base import compute_round, relu_mlp, value_weighted

    b = batch.vals.shape[0]
    emb = value_weighted(state.table[batch.ids.long()], batch.vals)
    x = emb.detach().requires_grad_(True)
    dense = [p.detach().requires_grad_(True) for p in state.dense]

    def mlp():
        return relu_mlp(dict(zip(model.dense_names, dense)), x, model.n_layers,
                        model.compute_dtype)

    def fwd():
        with torch.no_grad():
            mlp()

    def fwd_bwd():
        torch.autograd.grad(mlp().sum(), [x, *dense])

    dims = (x.shape[1], *model.hidden_dims, 1)
    flops = 3 * sum(2 * b * i * o for i, o in zip(dims[:-1], dims[1:]))
    rec = {
        "compute_dtype": model.compute_dtype,
        "route": "torch.matmul float32 over operands rounded to " + model.compute_dtype,
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "fwd_ms": time_ms(fwd, 50),
        "fwd_bwd_ms": time_ms(fwd_bwd, 50),
        "fwd_bwd_device_ms": device_ms(fwd_bwd, 20, None),
        "fwd_bwd_flops": flops,
        "fwd_bwd_bound_ms": 1e3 * flops / FP32_FLOPS_PER_S,
    }
    w0 = dict(zip(model.dense_names, state.dense))["w0"]
    xr, wr = compute_round(emb, "bfloat16"), compute_round(w0, "bfloat16")
    xb, wb = xr.to(torch.bfloat16), wr.to(torch.bfloat16)
    probe = {"w0_route_ms": time_ms(lambda: xr @ wr, 50)}
    try:  # a probe of this torch build, not a path of the port
        got = torch.mm(xb, wb, out_dtype=torch.float32)
        probe.update(available=True, w0_ms=time_ms(lambda: torch.mm(xb, wb, out_dtype=torch.float32), 50),
                     w0_max_abs_diff_vs_route=float((got - xr @ wr).abs().max()))
        try:
            torch.mm(xb.clone().requires_grad_(True), wb, out_dtype=torch.float32).sum().backward()
            probe["backward"] = True
        except RuntimeError as e:
            probe["backward"] = f"no: {str(e)[:160]}"
    except (RuntimeError, TypeError) as e:
        probe.update(available=False, error=str(e)[:160])
    rec["aten_mm_dtype"] = probe
    return rec


def phase_train_zoo(rng, tmp: str, key: str, paths: dict) -> dict:
    """One zoo config at full width through training.train, on the card and
    then on the CPU from one seeded npz (``_card_and_cpu``: B4 once per
    step, the order-2 FM and DeepFM the fm2_score pair once per step too
    (validation adds forwards), and no other kernel; tables, accumulators, a DeepFM's MLP, AUC);
    then the step time with the input on the card, a traced step and, for
    DeepFM, its MLP route (``_mlp_route``)."""
    from fast_tffm_tpu_torch.data.pipeline import batch_stream
    from fast_tffm_tpu_torch.models.base import Batch
    from fast_tffm_tpu_torch.trainer import make_train_step

    config, data, base, model = _zoo_base(key)
    name = f"train_{key}"
    table, dense, init = _seeded_init(rng, tmp, name, base, model, False)
    train_path, valid_path = paths[data]
    steps = ZOO_DATA[data]["train"] // base.batch_size

    def cfg_for(device):
        return _phase_cfg(base, tmp, name, device, init, train_files=(train_path,),
                          validation_files=(valid_path,), predict_files=(valid_path,), log_every=4)

    expect = {"rows_tail_adagrad": steps}
    if key in ORDER2_ZOO:
        expect.update(fm2_fwd=steps, fm2_bwd=steps)
    out = _card_and_cpu(name, cfg_for, model, table, steps, False, expect=expect, dense=dense)
    parsed, w = next(batch_stream([valid_path], batch_size=base.batch_size,
                                  vocabulary_size=base.vocabulary_size, max_nnz=base.max_nnz))
    batch = Batch.from_parsed(parsed, w, "cuda", with_fields=model.uses_fields)
    # Timed on the trained card state (the checks above are done with it).
    state, step = out["state"], make_train_step(model, base.learning_rate)
    times = _step_times(lambda: step(state, batch))
    rec = {
        "phase": name,
        "config": config,
        "model": base.model,
        "row_dim": model.row_dim,
        "max_nnz": base.max_nnz,
        "compute_dtype": base.compute_dtype,
        "thread_num": base.thread_num,
        **out["rec"],
        "step_ms_p50": times[len(times) // 2],
        "step_ms_min": times[0],
        "step_examples_per_s": base.batch_size / (times[len(times) // 2] / 1e3),
        "traced_step": traced_window(lambda: step(state, batch)),
    }
    if model.dense_names:
        rec["gradient"] = _mlp_gradient_check(model, out["cpu_state"], batch)
        rec["mlp"] = _mlp_route(model, state, batch)
    emit(rec)
    return {"cuda_cfg": out["cuda_cfg"], "launches": out["rec"]["launches"], "init": init,
            "auc": _logged(out["cuda_log"], "auc")}


def phase_serve_zoo(key: str, cuda_cfg, valid_path: str):
    """The trained card model serving the first ZOO_SERVE_LINES validation
    lines (libffm with their fields for FFM) through serve_lines on the
    card: every score finite and within the model's tolerance of the port's
    own CPU path on the same checkpoint, printed and unrounded; the order-2
    FM's and DeepFM's forward kernel (fm2_fwd), and DCN-V2's (dcn_cross_fwd),
    is the only kernel on this path (SERVE_FORWARD), FFM's has none."""
    import itertools

    import numpy as np

    from fast_tffm_tpu_torch.data.libsvm import parse_lines
    from fast_tffm_tpu_torch.models.base import Batch
    from fast_tffm_tpu_torch.prediction import load_scoring_state, make_score_fn
    from fast_tffm_tpu_torch.serving import serve_lines

    with open(valid_path) as f:
        lines = [s.strip() for s in itertools.islice(f, ZOO_SERVE_LINES)]
    atol, quiet = _score_atol(cuda_cfg), (lambda *_: None)
    out = io.StringIO()
    _zero_counters()
    t0 = time.perf_counter()
    snap = serve_lines(cuda_cfg, lines, out=out, log=log_stderr, device="cuda")
    serve_s = time.perf_counter() - t0
    launched = _wrapper_counts()
    fwd = SERVE_FORWARD.get(key)
    if not _launches_match(launched, {fwd: 1} if fwd else {}):
        fail(f"serve_{key} launched {launched}: its path has "
             + (f"the {fwd} forward alone" if fwd else "no kernel"))
    printed = np.array([float(v) for v in out.getvalue().split()], np.float64)
    if printed.shape != (ZOO_SERVE_LINES,) or not np.isfinite(printed).all():
        fail(f"serve_{key} returned {printed.shape[0]} scores, expected {ZOO_SERVE_LINES} finite")
    model, cpu_state = load_scoring_state(cuda_cfg, quiet, device="cpu")
    parsed = parse_lines(lines, vocabulary_size=cuda_cfg.vocabulary_size, max_nnz=cuda_cfg.max_nnz)
    batch = Batch.from_parsed(parsed, with_fields=model.uses_fields)
    want = make_score_fn(cuda_cfg, cpu_state, cuda_cfg.max_nnz, model=model)(cpu_state, batch).numpy()
    printed_err = float(np.abs(printed - np.array([float(f"{v:.6f}") for v in want])).max())
    _, gpu_state = load_scoring_state(cuda_cfg, quiet, device="cuda")
    got = make_score_fn(cuda_cfg, gpu_state, cuda_cfg.max_nnz, model=model)(
        gpu_state, batch.to("cuda")).cpu().numpy()
    raw_err = float(np.abs(got - want).max())
    if printed_err > atol + 1e-9 or raw_err > atol:
        fail(f"serve_{key}: card scores differ from the CPU path by {raw_err} (printed "
             f"{printed_err}; atol {atol})")
    total = snap["total_ms"]
    emit({"phase": f"serve_{key}", "config": ZOO.get(key, (DCNV2_CONFIG,))[0],
          "lines": ZOO_SERVE_LINES,
          "seconds": serve_s, "lines_per_s": ZOO_SERVE_LINES / serve_s,
          "p50_total_ms": total.get("p50"), "p99_total_ms": total.get("p99"),
          "compute_ms": snap["compute_ms"], "flushes": snap["flushes"],
          "max_abs_err_printed": printed_err, "max_abs_err_raw": raw_err, "atol": atol})


def phase_dcnv2(tmp: str, paths: dict) -> dict:
    """DCNV2_CONFIG at full width on the zoo's criteo-shaped data (its
    vocabulary cut to the data's 2^20 rows): ``training.train`` on the
    card, the cross pair ``cross_layers`` times a step each way (the
    validation batches' forwards too), B4 once a step and no other kernel,
    finite losses and a validation AUC.  Then, at DCNV2_CHECKED_DTYPE
    operands on the trained weights: one step's gradients (rows and every
    dense leaf) on the card against the CPU's on DCNV2_GRAD_ROWS validation
    rows, within DCNV2_GRAD_RTOL by relative norm, predict (card against CPU)
    and serve (``phase_serve_zoo``).  Returns the train run's launches."""
    import dataclasses
    import itertools

    import torch

    from fast_tffm_tpu_torch.config import build_model, load_config
    from fast_tffm_tpu_torch.data.libsvm import parse_lines
    from fast_tffm_tpu_torch.models.base import Batch
    from fast_tffm_tpu_torch.training import train

    t0 = time.perf_counter()
    train_path, valid_path = paths["criteo"]
    cfg = dataclasses.replace(
        load_config(os.path.join(HERE, DCNV2_CONFIG)), vocabulary_size=1 << 20,
        train_files=(train_path,), validation_files=(valid_path,), predict_files=(valid_path,),
        model_file=os.path.join(tmp, "train_dcnv2.ckpt"),
        score_path=os.path.join(tmp, "train_dcnv2.scores"), log_every=4).validate()
    steps = ZOO_DATA["criteo"]["train"] // cfg.batch_size
    valid_batches = -(-ZOO_DATA["criteo"]["valid"] // cfg.batch_size)
    log = []
    _zero_counters()
    t1 = time.perf_counter()
    state = train(cfg, log=log.append, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    launched = _wrapper_counts()
    layers = cfg.cross_layers
    want = {"rows_tail_adagrad": steps, "dcn_cross_fwd": layers * (steps + valid_batches),
            "dcn_cross_bwd": layers * steps}
    if launched != {**dict.fromkeys(KERNELS, 0), **want}:
        fail(f"train_dcnv2 launched {launched}, expected {want} and nothing else")
    losses, aucs = _logged(log, "loss"), _logged(log, "auc")
    if not losses or not all(map(math.isfinite, losses)) or len(aucs) != 1:
        fail(f"train_dcnv2: losses {losses}, validation aucs {aucs}")
    with open(valid_path) as f:
        lines = list(itertools.islice(f, DCNV2_GRAD_ROWS))
    parsed = parse_lines(lines, vocabulary_size=cfg.vocabulary_size, max_nnz=cfg.max_nnz)
    state.table, state.dense = state.table.cpu(), [p.cpu() for p in state.dense]
    checked = dataclasses.replace(cfg, compute_dtype=DCNV2_CHECKED_DTYPE)
    gradient = _mlp_gradient_check(build_model(checked), state, Batch.from_parsed(parsed),
                                   DCNV2_GRAD_RTOL)
    emit({"phase": "train_dcnv2", "config": DCNV2_CONFIG, "model": cfg.model,
          "factor_num": cfg.factor_num, "cross_layers": layers, "cross_rank": cfg.cross_rank,
          "hidden_dims": list(cfg.hidden_dims), "compute_dtype": cfg.compute_dtype,
          "vocabulary_size": cfg.vocabulary_size, "batch_size": cfg.batch_size, "steps": steps,
          "launches": launched, "losses": losses, "validation_auc": aucs[0],
          "train_s": train_s, "gradient": gradient, "checked_dtype": DCNV2_CHECKED_DTYPE})
    del state
    phase_predict(checked, "predict_dcnv2", rows=ZOO_DATA["criteo"]["valid"], anova=False,
                  atol=_score_atol(checked))
    phase_serve_zoo("dcnv2", checked, valid_path)
    emit({"phase": "dcnv2", "seconds": time.perf_counter() - t0})
    return launched


def phase_train_cached_deepfm(tmp: str, paths: dict, eager: dict) -> dict:
    """baseline4 with device_cache and steps_per_call = 8 (every 8 steps one
    CUDA-graph replay, cuBLAS products and the dense update inside), from
    train_deepfm's npz: B4 once per step in the replays (counted in the
    profiler trace), the fm2_score pair likewise, and the final state, dense leaves included, and the
    validation AUC bitwise train_deepfm's eager card run; the graph's step
    time beside the eager cached step's."""
    import torch

    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
    from fast_tffm_tpu_torch.data.binary import ensure_fmb_cache
    from fast_tffm_tpu_torch.data.device_cache import (
        epoch_index_chunks,
        load_device_dataset,
        make_cached_scan_train_step,
        make_cached_train_step,
    )

    name, kw = "train_cached_deepfm", {"device_cache": True, "binary_cache": True,
                                       "steps_per_call": 8}
    config, data, base, model = _zoo_base("deepfm")
    train_path, valid_path = paths[data]
    steps = ZOO_DATA[data]["train"] // base.batch_size
    attempts, result = [], {}

    def run_once():
        cfg, lines = _phase_cfg(base, tmp, name, "cuda", eager["init"], **kw, log_every=8,
                                train_files=(train_path,), validation_files=(valid_path,)), []
        attempts.append(lines)
        result["cfg"] = cfg
        result["state"] = _train_once(cfg, "cuda", lines)[0]

    run, wrappers = _counted_run(run_once, name, lambda: True)
    stepped = _step_launches(run, wrappers, True, name)
    if stepped != {**dict.fromkeys(KERNELS, 0), **dict.fromkeys(
            ("rows_tail_adagrad", "fm2_fwd", "fm2_bwd"), steps)}:
        fail(f"{name}: the replays launched {stepped} for {steps} steps")
    want = restore_checkpoint(eager["cuda_cfg"].model_file, torch.device("cpu"),
                              n_dense=len(model.dense_names), accum_width=model.row_dim)
    got = result["state"]
    pairs = [(got.table, want.table), (got.table_accum, want.table_accum),
             *zip(got.dense, want.dense), *zip(got.dense_accum, want.dense_accum)]
    if not (all(torch.equal(a.cpu(), b) for a, b in pairs) and got.step == want.step == steps):
        fail(f"{name}: steps_per_call = 8 is not bitwise the eager card run")
    if _logged(attempts[-1], "auc") != eager["auc"]:
        fail(f"{name}: validation AUC {_logged(attempts[-1], 'auc')} against the eager "
             f"run's {eager['auc']}")
    cfg = result["cfg"]
    data_set = load_device_dataset(
        ensure_fmb_cache(cfg.train_files, vocabulary_size=cfg.vocabulary_size,
                         max_nnz=cfg.max_nnz, log=log_stderr),
        batch_size=cfg.batch_size, vocabulary_size=cfg.vocabulary_size, max_nnz=cfg.max_nnz,
        device="cuda")
    scan, _ = make_cached_scan_train_step(model, cfg.learning_rate, data_set)
    step, _ = make_cached_train_step(model, cfg.learning_rate, data_set)
    idxs = epoch_index_chunks(data_set.batches, 8, "cuda")[0]
    index = torch.tensor(0, dtype=torch.int64, device="cuda")
    graph_ms = _step_times(lambda: scan(got, idxs), per_call=8)
    eager_ms = _step_times(lambda: step(got, index))
    replay = traced_window(lambda: scan(got, idxs))
    emit({"phase": name, "config": config + " + " + json.dumps(kw), "steps": steps,
          "launches": stepped, "launches_by_wrappers": wrappers,
          "launches_traced": run["launches_traced"], "bitwise_eager": True,
          "validation_auc": eager["auc"][-1], "wall_ms": run["wall_ms"],
          "examples_per_s_run": steps * cfg.batch_size / (run["wall_ms"] / 1e3),
          "examples_per_s_logged": _logged(attempts[-1], "examples/sec"),
          "device_idle_share": run["device_idle_share"],
          "graph_step_ms_p50": graph_ms[len(graph_ms) // 2],
          "eager_step_ms_p50": eager_ms[len(eager_ms) // 2],
          "graph_busy_ms_per_step": None if replay["device_busy_ms"] is None
          else replay["device_busy_ms"] / 8, "traced_replay": replay})
    return stepped


def phase_rows_tail_zoo(rng, label: str, path: str, batch: int, nnz: int, d: int) -> dict:
    """B4 at a zoo shape: the first training batch's ids ([batch, nnz], M =
    batch·nnz occurrences) onto a full-width [2^20, d] state, element and
    row accumulators at decay 1 and 0.9, each bitwise its twin on the card;
    at decay 1 the kernel's time on the sort's output (events; device, warm
    and L2-flushed), the update's (sort + kernel), the twin's, and the
    bound.  Returns the element record."""
    import numpy as np
    import torch

    from fast_tffm_tpu_torch.ops.tail import (
        rows_tail_adagrad_update,
        rows_tail_sorted,
        rows_tail_sorted_plain,
    )
    from fast_tffm_tpu_torch.optim import sparse_adagrad_update

    vocab, lr = 1 << 20, 0.05
    ids = torch.from_numpy(_first_batch_ids(path, vocab, batch, nnz)).cuda()
    grads = torch.from_numpy((rng.normal(size=(batch, nnz, d)) * 1e-3).astype(np.float32)).cuda()
    table = torch.from_numpy(rng.uniform(-0.01, 0.01, size=(vocab, d)).astype(np.float32)).cuda()
    flat_ids, flat_g = ids.reshape(-1), grads.reshape(-1, d)
    k = int(torch.unique(flat_ids).numel())
    main = None
    for acc in ("element", "row"):
        width = d if acc == "element" else 1
        accum = torch.from_numpy(rng.uniform(0.1, 0.5, size=(vocab, width)).astype(np.float32)).cuda()
        for decay in (1.0, 0.9):
            t_k, a_k, t_p, a_p = table.clone(), accum.clone(), table.clone(), accum.clone()
            rows_tail_adagrad_update(t_k, a_k, ids, grads, lr, decay=decay)
            sparse_adagrad_update(t_p, a_p, ids, grads, lr, decay=decay)
            torch.cuda.synchronize()
            if not (torch.equal(t_k, t_p) and torch.equal(a_k, a_p)):
                err = float(max((t_k - t_p).abs().max(), (a_k - a_p).abs().max()))
                fail(f"rows_tail {label}: not bitwise its plain version ({acc}, decay {decay}), "
                     f"max abs err {err}")
            rec = {"phase": "rows_tail", "shape": label, "accumulator": acc, "decay": decay,
                   "D": d, "N": nnz, "M": int(flat_ids.numel()), "K": k, "bitwise": True,
                   "max_abs_err": 0.0}
            if decay == 1.0:
                sid, order = torch.sort(flat_ids, stable=True)
                kern = f"rows_{acc}_kernel"
                kernel = lambda: rows_tail_sorted(t_k, a_k, sid, order, flat_g, lr)  # noqa: E731
                update = lambda: rows_tail_adagrad_update(t_k, a_k, ids, grads, lr)  # noqa: E731
                plain = lambda: rows_tail_sorted_plain(t_p, a_p, sid, order, flat_g, lr)  # noqa: E731
                rec.update({
                    "ms": time_ms(kernel, 50),
                    "device_ms": device_ms(kernel, 20, kern),
                    "device_ms_flushed": device_ms(flushed(kernel), 20, kern),
                    "update_ms": time_ms(update, 50),
                    "update_device_ms": device_ms(update, 20, None),
                    "plain_ms": time_ms(plain, 20),
                    "plain_device_ms": device_ms(plain, 10, None),
                })
                rec["bound_ms"], rec["bound_by"] = tail_bound(rec["M"], k, d, width)
                rec["sector_bound_ms"] = tail_sector_bound(rec["M"], k, d, width, fused=False)
                if acc == "element":
                    main = rec
            emit(rec)
    return main


# --- exact resume, convert, the packed element/row tails, dedup_gather_rows ---

RESUME_STOP = {"resume_streamed": 10, "resume_fmb_shuffled": 31, "resume_cached": 20}
DEDUP_CAP = BATCH * NNZ  # a batch's occurrences: a cap no batch can pass
DEDUP_SMALL_CAP = 16384  # below every baseline5 batch's ~144K unique ids


def _stop_hook(at_step: int, fired: list):
    """A ``step_hook`` that raises SIGTERM in this process once, after the
    call that reaches ``at_step``."""

    def hook(step):
        if step >= at_step and not fired:
            fired.append(step)
            os.kill(os.getpid(), signal.SIGTERM)

    return hook


@contextlib.contextmanager
def _captures():
    """Counts ``StepGraphs`` captures (CUDA-graph recordings) while active."""
    from fast_tffm_tpu_torch.utils.step_graph import StepGraphs

    real, box = StepGraphs._capture, {"n": 0}

    def counted(self, *a):
        box["n"] += 1
        return real(self, *a)

    StepGraphs._capture = counted
    try:
        yield box
    finally:
        StepGraphs._capture = real


def _card_train(what: str, make_cfg, *, graphed: bool, stop_at: int | None = None,
                resume: bool = True) -> dict:
    """One card run of ``training.train``, every kernel counter zeroed just
    before and read just after: an eager run's launches are the wrappers'
    counts; a graphed run's replays never pass a wrapper, so it runs under
    ``_counted_run`` and its trace counts them.  ``make_cfg()`` prepares a
    fresh model file for each attempt; ``stop_at`` raises SIGTERM from the
    step hook.  Returns the run's cfg, log, state, step launches, graph
    captures, the steps the hook saw and the wall time."""
    import torch

    result = {}

    def run_once():
        cfg, lines, fired = make_cfg(), [], []
        result.update(cfg=cfg, log=lines, fired=fired)
        hook = _stop_hook(stop_at, fired) if stop_at else None
        with _captures() as caps:
            result["state"], _ = _train_once(cfg, "cuda", lines, resume=resume, step_hook=hook)
        result["captures"] = caps["n"]

    if graphed:
        window, wrappers = _counted_run(run_once, what, lambda: True)
        result["launches"] = _step_launches(window, wrappers, True, what)
        result["wall_ms"] = window["wall_ms"]
        return result
    _zero_counters()
    t0 = time.perf_counter()
    run_once()
    torch.cuda.synchronize()
    result["wall_ms"] = 1e3 * (time.perf_counter() - t0)
    result["launches"] = _wrapper_counts()
    return result


def _expect_steps(what: str, launches: dict, steps: int, tail: str = "rows_tail_adagrad"):
    """An order-3 run of ``steps`` steps: B2 and ``tail`` once per step, B1
    at least once per step (validation adds some), the other tail never."""
    other = "fused_tail_adagrad" if tail == "rows_tail_adagrad" else "rows_tail_adagrad"
    if (launches["anova_bwd"] != steps or launches[tail] != steps
            or launches["anova_fwd"] < steps or launches[other]):
        fail(f"{what}: {launches} kernel launches for {steps} steps (tail {tail})")


def _logical_equal(a, b) -> bool:
    import torch

    return (a.step == b.step and torch.equal(a.table.cpu(), b.table.cpu())
            and torch.equal(a.table_accum.cpu(), b.table_accum.cpu()))


def _expected_cursor(cfg, epoch: int, batch: int) -> dict:
    from fast_tffm_tpu_torch.training import _files_fingerprint

    return {"version": 1, "epoch": epoch, "batch_in_epoch": batch,
            "batch_size": cfg.batch_size, "shuffle": cfg.shuffle,
            "shuffle_seed": cfg.shuffle_seed, "steps_per_call": cfg.steps_per_call,
            "files": _files_fingerprint(cfg.train_files)}


def _stop_and_resume(name: str, base, tmp: str, init: str, model, files: dict, stop_at: int,
                     steps: int, batches_per_epoch: int, tail: str = "rows_tail_adagrad") -> dict:
    """The uninterrupted card run, one stopped by SIGTERM from its step hook
    at ``stop_at`` (the call that reaches it), and its ``--resume``: the
    stopped run saves the cursor and returns, the resumed run reopens the
    input at it and ends bitwise equal to the uninterrupted run, each run
    launching the kernels once per step it took."""
    import shutil

    from fast_tffm_tpu_torch.checkpoint import read_input_cursor
    from fast_tffm_tpu_torch.trainer import unpack_state

    graphed = base.steps_per_call > 1
    whole = _card_train(f"{name} uninterrupted",
                        lambda: _phase_cfg(base, tmp, f"{name}_whole", "cuda", init, **files),
                        graphed=graphed)
    _expect_steps(f"{name} uninterrupted", whole["launches"], steps, tail)
    cut = _card_train(f"{name} stopped",
                      lambda: _phase_cfg(base, tmp, f"{name}_cut", "cuda", init, **files),
                      graphed=graphed, stop_at=stop_at)
    stopped = cut["state"].step
    if not cut["fired"] or cut["fired"][0] != stopped or not stop_at <= stopped < steps:
        fail(f"{name}: the run stopped at step {stopped}, the hook fired at {cut['fired']}")
    cfg = cut["cfg"]
    if not any(m.startswith(f"stopped on signal at step {stopped}") for m in cut["log"]):
        fail(f"{name}: the stopped run did not log its stop: {cut['log'][-3:]}")
    _expect_steps(f"{name} stopped", cut["launches"], stopped, tail)
    # A stop on an epoch's last batch leaves the cursor at that epoch's end.
    epoch, batch = divmod(stopped - 1, batches_per_epoch)
    batch += 1
    cursor = read_input_cursor(cfg.model_file)
    want = _expected_cursor(cfg, epoch, batch)
    if cursor != want:
        fail(f"{name}: the stopped run saved the cursor {cursor}, expected {want}")
    saved = os.path.join(tmp, f"{name}.stopped.ckpt")
    shutil.copy(cfg.model_file, saved)
    resumed = _card_train(f"{name} resumed",
                          lambda: _phase_cfg(base, tmp, f"{name}_cut", "cuda", saved, **files),
                          graphed=graphed)
    seek = f"resuming input at epoch {epoch}, batch {batch} (exact-position cursor)"
    if seek not in resumed["log"]:
        fail(f"{name}: the resumed run did not reopen the input at the cursor: "
             f"{resumed['log'][:4]}")
    _expect_steps(f"{name} resumed", resumed["launches"], steps - stopped, tail)
    a, b = unpack_state(whole["state"], model), unpack_state(resumed["state"], model)
    if not _logical_equal(a, b):
        err = float((a.table - b.table).abs().max())
        fail(f"{name}: the resumed run is not bitwise the uninterrupted one (table {err})")
    return {
        "steps": steps, "stop_at": stop_at, "stopped_at": stopped, "cursor": cursor,
        "bitwise": True,
        "launches": {"uninterrupted": whole["launches"], "stopped": cut["launches"],
                     "resumed": resumed["launches"]},
        "captures": {"uninterrupted": whole["captures"], "stopped": cut["captures"],
                     "resumed": resumed["captures"]},
        "wall_ms": {"uninterrupted": whole["wall_ms"], "stopped": cut["wall_ms"],
                    "resumed": resumed["wall_ms"]},
        "cut_cfg": cfg, "whole": whole,
    }


def _write_ini(path: str, config: str = CONFIG, **sections) -> str:
    """``config`` (configs/baseline5_fm_order3_kdd.cfg) with the given keys
    set, per section, written to ``path``."""
    import configparser

    ini = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
    with open(os.path.join(HERE, config)) as f:
        ini.read_file(f)
    for section, keys in sections.items():
        if not ini.has_section(section):
            ini.add_section(section)
        for k, v in keys.items():
            ini.set(section, k, str(v))
    with open(path, "w") as f:
        ini.write(f)
    return path


def _cli(args: list, timeout: int = 300) -> subprocess.CompletedProcess:
    """``python -m fast_tffm_tpu_torch.cli`` from the checkout."""
    return subprocess.run([sys.executable, "-m", "fast_tffm_tpu_torch.cli", *args], cwd=HERE,
                          capture_output=True, text=True, timeout=timeout)


def _cli_start(args: list) -> tuple[subprocess.Popen, float]:
    """``_cli(args)`` started, with its start time; ``_cli_end`` waits."""
    return subprocess.Popen([sys.executable, "-m", "fast_tffm_tpu_torch.cli", *args], cwd=HERE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True), time.perf_counter()


def _cli_end(started, timeout: int = 300) -> tuple[subprocess.CompletedProcess, float]:
    """A ``_cli_start`` run to its end (killed at ``timeout``, which raises
    as ``_cli`` does): its CompletedProcess and wall seconds."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return (subprocess.CompletedProcess(proc.args, proc.returncode, out, err),
            time.perf_counter() - t0)


def _cli_stop_and_resume(base, tmp: str, init: str, train_path: str, valid_path: str,
                         reference) -> dict:
    """``cli train --resume`` in a subprocess from the seeded npz, sent
    SIGTERM after its first logged window: it must log the stop and exit 0;
    ``cli train --resume`` then ends bitwise equal to ``reference``, the
    in-process uninterrupted run of the same config."""
    import shutil

    import torch

    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint

    model_file = os.path.join(tmp, "resume_cli.ckpt")
    shutil.copy(init, model_file)
    ini = _write_ini(
        os.path.join(tmp, "resume_cli.cfg"),
        General={"model_file": model_file},
        Train={"train_files": train_path, "validation_files": valid_path, "epoch_num": 2,
               "log_every": 4},
        Predict={"predict_files": valid_path, "score_path": model_file + ".scores"},
    )
    args = [sys.executable, "-m", "fast_tffm_tpu_torch.cli", "train", ini, "--resume"]
    proc = subprocess.Popen(args, cwd=HERE, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    lines, signalled = [], None
    t0 = time.perf_counter()
    try:
        for line in proc.stderr:
            lines.append(line.rstrip("\n"))
            if signalled is None and line.startswith("step "):
                proc.send_signal(signal.SIGTERM)
                signalled = lines[-1]
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    first_s = time.perf_counter() - t0
    stop = [m for m in lines if m.startswith("stopped on signal at step")]
    if rc != 0 or not stop:
        fail(f"cli train sent SIGTERM after {signalled!r} exited {rc} without a stop: "
             f"{lines[-5:]}")
    t0 = time.perf_counter()
    r = _cli(["train", ini, "--resume"])
    second_s = time.perf_counter() - t0
    seek = [m for m in r.stderr.splitlines() if m.startswith("resuming input at epoch")]
    if r.returncode != 0 or not seek:
        fail(f"cli train --resume after the stop exited {r.returncode}: {r.stderr[-2000:]}")
    got = restore_checkpoint(model_file, torch.device("cpu"), accum_width=base.factor_num + 1)
    if not _logical_equal(got, reference):
        fail("cli train stopped by SIGTERM and resumed is not bitwise the uninterrupted run")
    return {"signalled_after": signalled, "stop": stop[0], "exit_code": rc, "resume": seek[0],
            "bitwise": True, "seconds": {"stopped": first_s, "resumed": second_s}}


def _own_files(tmp: str, sub: str, *paths) -> list:
    """``paths`` linked (or copied) into ``tmp/sub``, so that the phase's
    binary caches are its own and the train_fmb phase still builds its."""
    d = os.path.join(tmp, sub)
    os.makedirs(d, exist_ok=True)
    out = []
    for p in paths:
        dst = os.path.join(d, os.path.basename(p))
        if not os.path.exists(dst):
            try:
                os.link(p, dst)
            except OSError:
                import shutil

                shutil.copy(p, dst)
        out.append(dst)
    return out


def _b5(**kw):
    """baseline5's config with ``kw`` set."""
    import dataclasses

    from fast_tffm_tpu_torch.config import load_config

    return dataclasses.replace(load_config(os.path.join(HERE, CONFIG)), **kw).validate()


def phase_resume_streamed(rng, tmp: str, train_path: str, valid_path: str) -> dict:
    """Rows layout, text through the native parser, 24 steps: stopped by the
    step hook at step 10 and resumed, bitwise the uninterrupted run; then
    the same config for 2 epochs through the CLI with a real SIGTERM."""
    from fast_tffm_tpu_torch.config import build_model
    from fast_tffm_tpu_torch.trainer import unpack_state

    name = "resume_streamed"
    base = _b5()
    model = build_model(base)
    _, _, init = _seeded_init(rng, tmp, name, base, model, False)
    files = dict(train_files=(train_path,), validation_files=(valid_path,),
                 predict_files=(valid_path,), log_every=4)
    rec = _stop_and_resume(name, base, tmp, init, model, files, RESUME_STOP[name],
                           TRAIN_BATCHES, TRAIN_BATCHES)
    reference = _card_train(f"{name} cli reference",
                            lambda: _phase_cfg(base, tmp, f"{name}_cli_ref", "cuda", init,
                                               **dict(files, epoch_num=2)),
                            graphed=False)
    _expect_steps(f"{name} cli reference", reference["launches"], 2 * TRAIN_BATCHES)
    rec["cli"] = _cli_stop_and_resume(base, tmp, init, train_path, valid_path,
                                      unpack_state(reference["state"], model))
    rec["launches"]["cli_reference"] = reference["launches"]
    out = {"plain": rec.pop("whole"), "base": base, "init": init, "files": files}
    rec.pop("cut_cfg")
    emit({"phase": name, "config": CONFIG, **rec})
    out["launches"] = rec["launches"]
    return out


def phase_resume_fmb_shuffled(rng, tmp: str, train_path: str, valid_path: str) -> dict:
    """binary_cache + shuffle, 2 epochs (48 steps), stopped at step 31
    (inside epoch 1, whose permutation the resumed stream redraws)."""
    from fast_tffm_tpu_torch.config import build_model

    name, kw = "resume_fmb_shuffled", {"binary_cache": True, "shuffle": True}
    train_path, valid_path = _own_files(tmp, "resume", train_path, valid_path)
    base = _b5(**kw)
    model = build_model(base)
    _, _, init = _seeded_init(rng, tmp, name, base, model, False)
    files = dict(train_files=(train_path,), validation_files=(valid_path,), epoch_num=2,
                 log_every=8)
    rec = _stop_and_resume(name, base, tmp, init, model, files, RESUME_STOP[name],
                           2 * TRAIN_BATCHES, TRAIN_BATCHES)
    rec.pop("whole"), rec.pop("cut_cfg")
    emit({"phase": name, "config": CONFIG + " + " + json.dumps(kw), **rec})
    return rec["launches"]


def phase_resume_cached(rng, tmp: str, train_path: str, valid_path: str, fused: bool) -> dict:
    """device_cache + shuffle + steps_per_call = 8, 2 epochs (48 steps),
    stopped at the call that holds step 20 (it ends at step 24, the end of
    epoch 0): bitwise the uninterrupted run, and the K-aligned resume makes
    no capture beyond the one length-8 graph an uninterrupted run makes."""
    from fast_tffm_tpu_torch.config import build_model

    name = "resume_cached_fused" if fused else "resume_cached"
    kw = {"device_cache": True, "binary_cache": True, "shuffle": True, "steps_per_call": 8}
    train_path, valid_path = _own_files(tmp, "resume", train_path, valid_path)
    base = _b5(**kw, **(FUSED if fused else {}))
    model = build_model(base)
    _, _, init = _seeded_init(rng, tmp, name, base, model, fused)
    files = dict(train_files=(train_path,), validation_files=(valid_path,), epoch_num=2,
                 log_every=8)
    tail = "fused_tail_adagrad" if fused else "rows_tail_adagrad"
    rec = _stop_and_resume(name, base, tmp, init, model, files, RESUME_STOP["resume_cached"],
                           2 * TRAIN_BATCHES, TRAIN_BATCHES, tail)
    rec.pop("whole"), rec.pop("cut_cfg")
    if rec["stopped_at"] != 24:
        fail(f"{name}: the call holding step 20 ended at step {rec['stopped_at']}, not 24")
    caps = rec["captures"]
    if not caps["resumed"] == caps["uninterrupted"] == 1:
        fail(f"{name}: graph captures {caps}: the K-aligned resume must make no extra one")
    emit({"phase": name, "config": CONFIG + " + " + json.dumps({**kw, **(FUSED if fused else {})}),
          **rec, "extra_captures": 0})
    return rec["launches"]


def phase_convert(rng, tmp: str, train_path: str, valid_path: str) -> dict:
    """``cli convert`` on a config whose files have no caches yet: every
    file packed, rc 0; then a binary_cache train run on the card (24 steps)
    that finds the caches fresh and rebuilds none."""
    import shutil

    from fast_tffm_tpu_torch.config import build_model, load_config

    d = os.path.join(tmp, "convert")
    os.makedirs(d, exist_ok=True)
    files = [shutil.copy(p, d) for p in (train_path, valid_path)]
    model_file = os.path.join(d, "convert.ckpt")
    ini = _write_ini(
        os.path.join(d, "convert.cfg"), General={"model_file": model_file},
        Train={"train_files": files[0], "validation_files": files[1], "binary_cache": "true",
               "log_every": 4},
        Predict={"predict_files": files[1], "score_path": model_file + ".scores"},
    )
    t0 = time.perf_counter()
    r = _cli(["convert", ini])
    seconds = time.perf_counter() - t0
    packed = [f"{p} -> {p}.fmb" for p in files]
    if r.returncode != 0 or any(line not in r.stdout.splitlines() for line in packed):
        fail(f"cli convert exited {r.returncode}: {r.stdout[-1000:]} {r.stderr[-2000:]}")
    stamps = {p: os.stat(p + ".fmb").st_mtime_ns for p in files}
    base = load_config(ini)
    model = build_model(base)
    _, _, init = _seeded_init(rng, tmp, "convert", base, model, False)
    run = _card_train("convert train",
                      lambda: _phase_cfg(base, tmp, "convert", "cuda", init), graphed=False)
    _expect_steps("convert train", run["launches"], TRAIN_BATCHES)
    built = [m for m in run["log"] if m.startswith("building binary cache")]
    if built or any(os.stat(p + ".fmb").st_mtime_ns != t for p, t in stamps.items()):
        fail(f"the train run after convert rebuilt caches: {built}")
    emit({"phase": "convert", "files": len(files), "seconds": seconds,
          "stdout": r.stdout.splitlines(), "train_rebuilt_caches": 0,
          "train_launches": run["launches"]})
    return run["launches"]


def phase_train_packed(rng, tmp: str, train_path: str, valid_path: str, accumulator: str):
    """table_layout = packed with an element or row accumulator, 24 steps:
    kernel B4 at the packed address once per step, the card's logical
    arrays within the train phase's bounds of the CPU run's, and bitwise
    the card's rows-layout run with the same accumulator from one npz; the
    step time p50 of each layout with the input on the card, and a traced
    step's device busy time."""
    from fast_tffm_tpu_torch.config import build_model
    from fast_tffm_tpu_torch.data.pipeline import batch_stream
    from fast_tffm_tpu_torch.models.base import Batch
    from fast_tffm_tpu_torch.trainer import make_packed_train_step, make_train_step, unpack_state

    name = f"train_packed_{accumulator}"
    kw = {"table_layout": "packed", "adagrad_accumulator": accumulator}
    base = _b5(**kw)
    model = build_model(base)
    table, _, init = _seeded_init(rng, tmp, name, base, model, accumulator == "row")
    files = dict(train_files=(train_path,), validation_files=(valid_path,),
                 predict_files=(valid_path,), log_every=4)
    out = _card_and_cpu(name, lambda device: _phase_cfg(base, tmp, name, device, init, **files),
                        model, table, TRAIN_BATCHES, False)
    if out["state"].layout != "packed":
        fail(f"{name}: the run trained a {out['state'].layout} state")
    rows_base = _b5(adagrad_accumulator=accumulator)
    rows = _card_train(f"{name} rows reference",
                       lambda: _phase_cfg(rows_base, tmp, f"{name}_rows", "cuda", init, **files),
                       graphed=False)
    _expect_steps(f"{name} rows reference", rows["launches"], TRAIN_BATCHES)
    if not _logical_equal(unpack_state(out["state"], model), rows["state"]):
        fail(f"{name}: the packed run is not bitwise the card's rows run")
    # Step time with a validation batch on the card, packed and rows in
    # turns, continuing from each run's trained state; then one traced step.
    parsed, w = next(batch_stream([valid_path], batch_size=BATCH,
                                  vocabulary_size=base.vocabulary_size, max_nnz=NNZ))
    batch = Batch.from_parsed(parsed, w).to("cuda")
    steps = {"packed": lambda st=out["state"], f=make_packed_train_step(model, base.learning_rate):
             f(st, batch),
             "rows": lambda st=rows["state"], f=make_train_step(model, base.learning_rate):
             f(st, batch)}
    times = {k: [] for k in steps}
    for k in ("packed", "rows", "rows", "packed"):
        times[k] += _step_times(steps[k])
    p50 = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    busy = {k: traced_window(f)["device_busy_ms"] for k, f in steps.items()}
    rec = out["rec"]
    emit({"phase": name, "config": CONFIG + " + " + json.dumps(kw), **rec,
          "bitwise_rows_run": True, "rows_launches": rows["launches"],
          "step_ms_p50": p50, "step_busy_ms": busy})
    return rec["launches"]


def phase_train_dedup(tmp: str, plain: dict) -> dict:
    """dedup_gather_rows on the resume_streamed phase's config and npz (rows,
    native text, 24 steps) at K = 1 (eager) and K = 8 (CUDA-graph replays):
    the port gathers directly and checks each batch's unique ids against
    the cap, so both are bitwise the plain uninterrupted run; then a cap
    below the batches' unique ids (16,384) fails before any batch ships,
    naming the knob."""
    import dataclasses

    from fast_tffm_tpu_torch.utils.prefetch import PrefetchError

    base, init, files = plain["base"], plain["init"], plain["files"]
    rec, launches = {"cap": DEDUP_CAP}, {}
    for k in (1, 8):
        cfg_base = dataclasses.replace(base, dedup_gather_rows=DEDUP_CAP, steps_per_call=k)
        run = _card_train(f"train_dedup K={k}",
                          lambda cb=cfg_base, k=k: _phase_cfg(cb, tmp, f"train_dedup_k{k}",
                                                              "cuda", init, **files),
                          graphed=k > 1)
        _expect_steps(f"train_dedup K={k}", run["launches"], TRAIN_BATCHES)
        if not _logical_equal(run["state"], plain["plain"]["state"]):
            fail(f"train_dedup: dedup_gather_rows at K = {k} is not bitwise the plain run")
        if k > 1 and run["captures"] != 1:
            fail(f"train_dedup: {run['captures']} graph captures at K = 8 (24 steps: one)")
        launches[f"k{k}"] = run["launches"]
        rec[f"k{k}"] = {"bitwise_plain": True, "captures": run["captures"],
                        "wall_ms": run["wall_ms"], "launches": run["launches"]}
    small = _phase_cfg(dataclasses.replace(base, dedup_gather_rows=DEDUP_SMALL_CAP), tmp,
                       "train_dedup_small", "cuda", init, **files)
    before = open(small.model_file, "rb").read()
    _zero_counters()
    try:
        _train_once(small, "cuda", [])
        fail("train_dedup: a cap below a batch's unique ids trained")
    except PrefetchError as e:
        msg = str(e)
    counts = _wrapper_counts()
    if f"dedup_gather_rows = {DEDUP_SMALL_CAP} but a batch carries" not in msg or any(
            counts.values()) or open(small.model_file, "rb").read() != before:
        fail(f"train_dedup: the over-cap run ({msg}) launched {counts} or wrote the model")
    rec["over_cap"] = {"cap": DEDUP_SMALL_CAP, "error": msg, "launches": counts}
    emit({"phase": "train_dedup", "config": CONFIG, **rec})
    return launches


def phase_packed_tail(rng, train_path: str) -> dict:
    """Kernel B4 at the packed address (``rows_tail_sorted(packed=True)``) on a
    full-width packed state from a seeded [2^20, 9] table, against its plain
    twin on the card, bitwise: element and row accumulators, decay 1 and
    0.9, the first batch's ids, one id, the ids of the last, partial tile
    row and the padded batch's hot id 0; pad lanes and slots untouched;
    unpacked, bitwise the rows kernel on the logical arrays.  Times at the
    first batch: the kernel on the sort's output (events; device time
    L2-warm and flushed), the update (sort + kernel) and the twin, beside
    the bytes and sector bounds (the rows layout's: the same rows move)."""
    import numpy as np
    import torch

    from fast_tffm_tpu_torch.ops.packed_table import (
        pack_accum_any,
        pack_table,
        rows_per_tile,
        unpack_accum_any,
        unpack_table,
    )
    from fast_tffm_tpu_torch.ops.tail import (
        rows_tail_adagrad_update,
        rows_tail_sorted,
        rows_tail_sorted_plain,
    )

    vocab, d, lr = 1 << 20, 1 + 8, 0.05
    p = rows_per_tile(d)
    ids = torch.from_numpy(_first_batch_ids(train_path, vocab)).cuda()
    grads = torch.from_numpy((rng.normal(size=(BATCH, NNZ, d)) * 1e-3).astype(np.float32)).cuda()
    table = torch.from_numpy(rng.uniform(-0.01, 0.01, size=(vocab, d)).astype(np.float32)).cuda()
    accums = {
        "element": torch.from_numpy(rng.uniform(0.1, 0.5, (vocab, d)).astype(np.float32)).cuda(),
        "row": torch.from_numpy(rng.uniform(0.1, 0.5, (vocab, 1)).astype(np.float32)).cuda(),
    }
    last = torch.arange(vocab - vocab % p, vocab, dtype=torch.int32).to(ids.device)
    sets = {
        "batch": (ids, grads),
        "one id": (ids[:1, :1], grads[:1, :1]),
        "last tile row": (last, grads.reshape(-1, d)[: last.numel()]),
        "hot id 0": _padded_batch(ids, grads),
    }
    cases = [("element", 1.0, "batch"), ("element", 0.9, "batch"), ("row", 1.0, "batch"),
             ("row", 0.9, "batch"), ("element", 1.0, "one id"), ("row", 1.0, "one id"),
             ("element", 1.0, "last tile row"), ("row", 0.9, "last tile row"),
             ("element", 1.0, "hot id 0"), ("row", 0.9, "hot id 0")]
    out = {}
    for acc, decay, which in cases:
        c_ids, c_grads = sets[which]
        flat_ids, flat_g = c_ids.reshape(-1), c_grads.reshape(-1, d).contiguous()
        sid, order = torch.sort(flat_ids, stable=True)
        tp, ap = pack_table(table), pack_accum_any(accums[acc], d, 0.1)
        t_k, a_k, t_p, a_p = tp.clone(), ap.clone(), tp.clone(), ap.clone()
        rows_tail_sorted(t_k, a_k, sid, order, flat_g, lr, decay=decay, packed=True)
        rows_tail_sorted_plain(t_p, a_p, sid, order, flat_g, lr, decay, packed=True)
        t_r, a_r = table.clone(), accums[acc].clone()
        rows_tail_adagrad_update(t_r, a_r, c_ids, c_grads, lr, decay=decay)
        torch.cuda.synchronize()
        k = int(torch.unique(c_ids).numel())
        where = f"{acc} accumulator, decay {decay}, {which} (K={k})"
        if not (torch.equal(t_k, t_p) and torch.equal(a_k, a_p)):
            fail(f"packed_tail is not bitwise its plain version: {where}")
        if not (torch.equal(unpack_table(t_k, vocab, d), t_r)
                and torch.equal(unpack_accum_any(a_k, vocab, d), a_r)):
            fail(f"packed_tail, unpacked, is not bitwise the rows kernel: {where}")
        # Pad lanes (126, 127) and the last tile row's pad slots keep their values.
        tail_floats = (-vocab) % p * d + (128 - p * d)
        if not (torch.equal(t_k[:, p * d:], tp[:, p * d:])
                and torch.equal(t_k.view(-1)[-tail_floats:], tp.view(-1)[-tail_floats:])):
            fail(f"packed_tail wrote a pad lane or slot: {where}")
        rec = {"phase": "packed_tail", "accumulator": acc, "decay": decay, "ids": which,
               "P": p, "M": int(flat_ids.numel()), "K": k, "bitwise": True,
               "bitwise_rows_kernel": True, "max_abs_err": 0.0}
        if which == "batch" and decay == 1.0:
            m, a = flat_ids.numel(), d if acc == "element" else 1
            kern = f"rows_{acc}_kernel"
            kernel = lambda: rows_tail_sorted(  # noqa: E731
                t_k, a_k, sid, order, flat_g, lr, packed=True)
            rec.update({
                "ms": time_ms(kernel, 100),
                "device_ms": device_ms(kernel, 30, kern),
                "device_ms_flushed": device_ms(flushed(kernel), 30, kern),
                "update_ms": time_ms(lambda: rows_tail_adagrad_update(
                    t_k, a_k, c_ids, c_grads, lr, packed=True), 100),
                "update_device_ms": device_ms(lambda: rows_tail_adagrad_update(
                    t_k, a_k, c_ids, c_grads, lr, packed=True), 30, None),
                "plain_ms": time_ms(lambda: rows_tail_sorted_plain(
                    t_p, a_p, sid, order, flat_g, lr, packed=True), 30),
                "plain_device_ms": device_ms(lambda: rows_tail_sorted_plain(
                    t_p, a_p, sid, order, flat_g, lr, packed=True), 10, None),
            })
            rec["bound_ms"], rec["bound_by"] = tail_bound(m, k, d, a)
            rec["sector_bound_ms"] = tail_sector_bound(m, k, d, a, fused=False)
            out[acc] = {x: rec[x] for x in ("P", "M", "K", "ms", "device_ms",
                                            "device_ms_flushed", "update_ms",
                                            "update_device_ms", "plain_ms", "plain_device_ms",
                                            "bound_ms", "bound_by", "sector_bound_ms")}
        emit(rec)
    return out


# --- telemetry, profiling and the async/delta checkpoint writer ----------------
#
# An eager run's launches are the wrappers' counts.  A K-step run's replays
# pass no wrapper: it runs under chip_smoke's own profiler (``_counted_run``)
# and its trace counts them, as train_cached's do.  A run with a profile
# window never opens that profiler (a run's StepProfiler owns the one
# torch.profiler a process may have open): such runs are eager, and the
# window's trace is held against the wrappers' counts taken at its start
# and stop (``_window_launches``).

DELTA_EVERY = 8
FFM_STEPS = 16


def _model_files(cfg) -> list:
    import glob

    return sorted(glob.glob(glob.escape(cfg.model_file) + "*"))


def _run(what: str, cfg, hook=None, expect_abort: bool = False, make_hook=None,
         trace: bool = False, resume: bool = True, entry: str = "train") -> dict:
    """One card run of ``training.train`` of an order-3 FM (or, eager, any
    model), every kernel counter zeroed just before and read just after.
    ``hook`` is its step hook, or ``make_hook()`` makes a fresh one for
    each attempt (it may arm a fault plan or start a stream writer);
    ``expect_abort`` a run the hook ends by raising ``_Abort`` (no final
    save).  Its ``launches`` are those its train steps made: an eager run's
    are the wrappers' counts; a K-step run's (or with ``trace`` an eager
    run's too) are counted in a profiler trace of the run
    (``_counted_run``, replays = trace less wrappers, ``_step_launches``),
    each retry from the model files (base, deltas and a tiered run's
    ``.store`` directory) and metrics the run started with; ``resume``
    False starts from a fresh init; ``entry`` names the training entry
    (``train`` or ``dist_train``).  Returns the state (None when aborted), the log, the wall
    time, the counts and, traced, the card's busy time and idle share."""
    import shutil

    import torch

    graphed = cfg.steps_per_call > 1
    traced = graphed or trace
    head, name = os.path.split(cfg.model_file)
    keep = os.path.join(head, f".keep.{name}")
    start = _model_files(cfg)
    def copy(src, dst):
        (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, dst)

    if traced:
        os.makedirs(keep, exist_ok=True)
        for path in start:
            copy(path, os.path.join(keep, os.path.basename(path)))
    result = {}

    def run_once():
        if traced:  # a retry starts from the files the first attempt had
            for path in _model_files(cfg):
                (shutil.rmtree if os.path.isdir(path) else os.remove)(path)
            for path in start:
                copy(os.path.join(keep, os.path.basename(path)), path)
        if cfg.metrics_path and os.path.exists(cfg.metrics_path):
            os.remove(cfg.metrics_path)
        lines, state = [], None
        step_hook = make_hook() if make_hook is not None else hook
        try:
            state, _ = _train_once(cfg, "cuda", lines, resume=resume, step_hook=step_hook,
                                   entry=entry)
            if expect_abort:
                fail(f"{what}: the run was to be aborted by its step hook and ended")
        except _Abort:
            if not expect_abort:
                raise
        result.update(state=state, log=lines)

    out = {"cfg": cfg}
    if traced:
        window, wrappers = _counted_run(run_once, what, lambda: graphed)
        out["launches"] = _step_launches(window, wrappers, graphed, what)
        out.update(wall_ms=window["wall_ms"], wrappers=wrappers,
                   trace_attempts=window["trace_attempts"],
                   trace_lost_events=window.get("trace_lost_events"),
                   device_busy_ms=window["device_busy_ms"],
                   device_idle_share=window["device_idle_share"])
        shutil.rmtree(keep)
    else:
        _zero_counters()
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        out["wall_ms"] = 1e3 * (time.perf_counter() - t0)
        out["wrappers"] = _wrapper_counts()
        out["launches"] = dict(out["wrappers"])
    return {**out, **result}


class _Abort(Exception):
    """Ends a run from its step hook before its final save."""


def _abort_at(step_at: int):
    def hook(step):
        if step >= step_at:
            raise _Abort(step)

    return hook


def _records(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _check_records(what: str, records: list) -> dict:
    """Every record's envelope and its kind's required keys (the JAX
    package's SCHEMAS); no steady-state compile.  Returns the counts by kind."""
    from fast_tffm_tpu_torch.telemetry import ENVELOPE_FIELDS, SCHEMAS

    kinds: dict = {}
    for r in records:
        missing = [k for k in (*ENVELOPE_FIELDS, *SCHEMAS.get(r.get("kind"), ("?",)))
                   if k not in r]
        if missing:
            fail(f"{what}: a {r.get('kind')} record lacks {missing}: {str(r)[:300]}")
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    summary = [r for r in records if r["kind"] == "summary"]
    if len(summary) != 1 or summary[0]["steady_compiles"] != 0:
        fail(f"{what}: summary {summary} (one, with steady_compiles 0, expected)")
    if any(r["kind"] == "compile" and not r["warmup"] for r in records):
        fail(f"{what}: a steady-state compile record")
    return kinds


def _restored(path: str, width: int):
    import torch

    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint

    return restore_checkpoint(path, torch.device("cpu"), accum_width=width)


def _same_files(what: str, a: str, b: str, width: int, cursor: bool = True) -> None:
    """Two checkpoints (chains replayed) hold the same step, table and
    accumulators, bit for bit, and (``cursor``) the same cursor.  (Their
    save_id and published_at members differ by design.)"""
    from fast_tffm_tpu_torch.checkpoint import read_input_cursor

    if not _logical_equal(_restored(a, width), _restored(b, width)):
        fail(f"{what}: {os.path.basename(a)} and {os.path.basename(b)} differ")
    if cursor and read_input_cursor(a) != read_input_cursor(b):
        fail(f"{what}: the cursors differ: {read_input_cursor(a)} against {read_input_cursor(b)}")


def _step_clock():
    """A step hook that stamps the host clock after every call, and the p50
    of the gaps between calls (the loop's step time), the first two gaps
    dropped (builds, capture, warm-up)."""
    stamps = []

    def hook(step):
        stamps.append(time.perf_counter())

    def p50():
        gaps = sorted(1e3 * (b - a) for a, b in zip(stamps[2:], stamps[3:]))
        return gaps[len(gaps) // 2] if gaps else None

    return hook, p50


def _trace_kernels(path: str) -> tuple[dict, str | None]:
    """Kernel launches by name of KERNELS in a chrome trace file, and the
    first of them in launch order."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    found = sorted((float(e.get("ts", 0.0)), k) for e in events
                   if str(e.get("cat", "")).lower() == "kernel"
                   for k, syms in KERNEL_SYMBOLS.items()
                   if any(s in e.get("name", "") for s in syms))
    counts = {k: sum(1 for _, name in found if name == k) for k in KERNEL_SYMBOLS}
    return counts, found[0][1] if found else None


@contextlib.contextmanager
def _window_counts():
    """The wrappers' counts when a run's StepProfiler starts its trace and
    when it stops it (after the window's last call), while active."""
    from fast_tffm_tpu_torch.profiling import StepProfiler

    real, box = StepProfiler._emit, {}

    def counted(self, step, event, **extra):
        box[event] = _wrapper_counts()
        return real(self, step, event, **extra)

    StepProfiler._emit = counted
    try:
        yield box
    finally:
        StepProfiler._emit = real


def _window_launches(what: str, path: str, box: dict) -> dict:
    """A profile window's trace against the wrappers' launches inside it
    (the run is eager: every launch passes a wrapper): equal, or short by
    exactly the window's first launch, a forward (the one loss seen in a
    long process, PERF.md section 6).  Anything else fails."""
    traced, first = _trace_kernels(path)
    want = {k: box["trace_stop"][k] - box["trace_start"][k] for k in KERNELS}
    rec = {"launches_traced": traced, "launches_by_wrappers": want, "first_traced": first}
    if traced == want:
        return rec
    for fwd in FORWARD_OF.values():
        if dict(traced, **{fwd: traced[fwd] + 1}) == want and first != fwd and want[fwd] > 0:
            rec["trace_lost_events"] = {fwd: 1}
            log_stderr(f"{what}: the profile window's trace lost its first forward launch")
            return rec
    fail(f"{what}: the profile window's trace counts {traced} kernel launches, the "
         f"wrappers {want} (first traced: {first})")


def phase_telemetry_train(tmp: str, train_cfg) -> dict:
    """The train phase's config and npz (rows, native text, 24 steps) with
    metrics_path, profile_steps 8:12, datastats every 4 steps, the watchdog
    at 60 s and memory every 0.5 s: every record's envelope and keys, no
    steady-state compile, the profile window's start and stop and its trace
    against the wrappers' launches inside the window (``_window_launches``;
    one forward, one backward and one tail a step), the memory records above the
    table and accumulators' bytes, and the final state bitwise the
    uninstrumented train phase's.  The loop's step p50 with and without the
    telemetry, in turns (plain, instrumented, instrumented, plain); its cost
    is measured in ``phase_telemetry_cost``."""
    init = os.path.join(tmp, "train.init.ckpt")
    files = dict(train_files=train_cfg.train_files, validation_files=train_cfg.validation_files,
                 predict_files=train_cfg.predict_files, log_every=4)
    on = dict(telemetry_profile_steps="8:12", telemetry_datastats_every_steps=4,
              telemetry_stall_timeout_s=60.0, telemetry_mem_every_s=0.5)
    state_bytes = 2 * train_cfg.vocabulary_size * (train_cfg.factor_num + 1) * 4
    p50s = {"plain": [], "telemetry": []}
    rec, windows = {"phase": "telemetry_train", "config": CONFIG, **on}, []
    for i, mode in enumerate(("plain", "telemetry", "telemetry", "plain")):
        metrics = os.path.join(tmp, f"telemetry_train.{i}.jsonl")
        cfg = _phase_cfg(train_cfg, tmp, f"telemetry_train_{i}", "cuda", init, **files,
                         **(dict(on, metrics_path=metrics) if mode == "telemetry" else {}))
        hook, p50 = _step_clock()
        with _window_counts() as box:
            run = _run(f"telemetry_train {mode}", cfg, hook)
        p50s[mode].append(p50())
        _expect_steps(f"telemetry_train {mode}", run["launches"], TRAIN_BATCHES)
        _same_files(f"telemetry_train {mode} against train", cfg.model_file,
                    train_cfg.model_file, train_cfg.factor_num + 1)
        if mode == "plain":
            continue
        records = _records(metrics)
        kinds = _check_records("telemetry_train", records)
        want = {"train", "input", "validation", "ckpt", "profile", "datastats", "mem", "summary"}
        if not want <= set(kinds):
            fail(f"telemetry_train: kinds {sorted(kinds)}, expected at least {sorted(want)}")
        trace = [r for r in records if r["kind"] == "profile" and r["program"] == "trace"]
        if [r["event"] for r in trace] != ["trace_start", "trace_stop"] or trace[0]["step"] < 8:
            fail(f"telemetry_train: profile window records {trace}")
        in_trace = _window_launches("telemetry_train", trace[1]["trace_path"], box)
        steps = trace[1]["step"] - trace[0]["step"]
        if in_trace["launches_by_wrappers"] != {**dict.fromkeys(KERNELS, 0), **dict.fromkeys(
                ("anova_fwd", "anova_bwd", "rows_tail_adagrad"), steps)}:
            fail(f"telemetry_train: the window of {steps} steps launched "
                 f"{in_trace['launches_by_wrappers']}")
        windows.append(in_trace)
        mem = [r["device_bytes"] for r in records if r["kind"] == "mem"]
        if not mem or min(mem) < state_bytes:
            fail(f"telemetry_train: mem device_bytes {mem} below the state's {state_bytes}")
        ds = [r for r in records if r["kind"] == "datastats"]
        if not ds or any(r["ids"] != BATCH * NNZ for r in ds):
            fail(f"telemetry_train: datastats {ds}")
        rec.update(kinds=kinds, launches=run["launches"], trace_windows=windows,
                   trace_seconds=trace[1].get("trace_s"), mem_device_bytes=[min(mem), max(mem)],
                   datastats=ds[-1], summary=[r for r in records if r["kind"] == "summary"][0],
                   bitwise_train=True, profile_programs=sorted(
                       r["program"] for r in records if r["kind"] == "profile"))
    rec["step_ms_p50"] = p50s
    emit(rec)
    return rec["launches"]


def phase_telemetry_cached(tmp: str, train_cfg) -> dict:
    """The train_cached phase's config and npz (device cache, shuffle, K = 8,
    2 epochs) with metrics_path: the graph capture is a warm-up compile, no
    steady-state one; train_step and train_graph_k8 profile records; the
    final state bitwise the uninstrumented train_cached card run's; its
    replayed launches counted in a trace of the run."""
    kw = {"device_cache": True, "binary_cache": True, "shuffle": True, "steps_per_call": 8}
    base = _b5(**kw)
    metrics = os.path.join(tmp, "telemetry_cached.jsonl")
    cfg = _phase_cfg(base, tmp, "telemetry_cached", "cuda",
                     os.path.join(tmp, "train_cached.init.ckpt"),
                     train_files=train_cfg.train_files,
                     validation_files=train_cfg.validation_files, epoch_num=2, log_every=8,
                     metrics_path=metrics)
    run = _run("telemetry_cached", cfg)
    records = _records(metrics)
    kinds = _check_records("telemetry_cached", records)
    compiles = [r for r in records if r["kind"] == "compile"]
    if sum(r["compiles"] for r in compiles) < 1:
        fail(f"telemetry_cached: the capture was not counted: {compiles}")
    programs = sorted(r["program"] for r in records if r["kind"] == "profile")
    if programs != ["train_graph_k8", "train_step"]:
        fail(f"telemetry_cached: profile records {programs}")
    _expect_steps("telemetry_cached", run["launches"], 2 * TRAIN_BATCHES)
    _same_files("telemetry_cached against train_cached", cfg.model_file,
                os.path.join(tmp, "train_cached.cuda.ckpt"), base.factor_num + 1)
    emit({"phase": "telemetry_cached", "config": CONFIG + " + " + json.dumps(kw),
          "kinds": kinds, "compiles": compiles, "launches": run["launches"],
          "wrappers": run["wrappers"], "trace_attempts": run["trace_attempts"],
          "trace_lost_events": run["trace_lost_events"], "wall_ms": run["wall_ms"],
          "bitwise_train_cached": True,
          "summary": [r for r in records if r["kind"] == "summary"][0]})
    return run["launches"]


COST_ROUNDS = 8  # rounds of (plain, monitor, datastats), every other one reversed
COST_GAPS = (4, 52)  # the step gaps measured: after step 4 to step 52


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def phase_telemetry_cost(tmp: str, big_path: str) -> dict:
    """The telemetry's cost on the loop: the throughput phase's streamed
    native epoch (1,048,576 rows, 64 eager steps, no validation, no save)
    in rounds of plain, ``monitor`` (metrics_path, the watchdog at 60 s,
    memory every 0.5 s, a profile window at steps 56:60) and ``datastats``
    (the same and datastats every 4 steps), COST_ROUNDS rounds, every other
    one reversed.  Each run's step time is the host clock's gaps between
    step hooks after step 4 to step 52 (48 gaps, the profile window after
    them), as its p50 and its mean.  Per mode: the median of the runs;
    per round, each mode's time relative to the same round's plain run
    (pairing cancels the host's drift across the call).  A mode's cost is
    resolved when every round agrees in sign (a sign test: 2 / 2^8 < 0.01);
    the smallest difference the rounds resolve is taken as half the range
    of the paired differences."""
    import dataclasses

    import torch

    from fast_tffm_tpu_torch.config import load_config

    base = dataclasses.replace(
        load_config(os.path.join(HERE, CONFIG)), train_files=(big_path,), validation_files=(),
        predict_files=(), save_every_epochs=0,
    )
    monitor = dict(telemetry_stall_timeout_s=60.0, telemetry_mem_every_s=0.5,
                   telemetry_profile_steps="56:60")
    modes = {"plain": {}, "monitor": monitor,
             "datastats": dict(monitor, telemetry_datastats_every_steps=4)}
    lo, hi = COST_GAPS
    rounds = []
    for r in range(COST_ROUNDS):
        got = {}
        for mode in (list(modes) if r % 2 == 0 else list(modes)[::-1]):
            i = len(rounds) * len(modes) + len(got)
            kw = dict(modes[mode])
            if kw:
                kw["metrics_path"] = os.path.join(tmp, f"telemetry_cost.{i}.jsonl")
            cfg = dataclasses.replace(
                base, model_file=os.path.join(tmp, f"telemetry_cost.{i}.ckpt"), **kw).validate()
            stamps = []
            _zero_counters()
            t0 = time.perf_counter()
            _train_once(cfg, "cuda", [], resume=False,
                        step_hook=lambda step: stamps.append(time.perf_counter()))
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            launches = _wrapper_counts()
            if launches["anova_fwd"] != THROUGHPUT_BATCHES:
                fail(f"telemetry_cost {mode}: {launches} for {THROUGHPUT_BATCHES} steps")
            _expect_steps(f"telemetry_cost {mode}", launches, THROUGHPUT_BATCHES)
            if kw:
                _check_records(f"telemetry_cost {mode}", _records(kw["metrics_path"]))
            # stamps[j] follows step j + 1.
            gaps = sorted(1e3 * (b - a) for a, b in zip(stamps[lo - 1:hi - 1], stamps[lo:hi]))
            got[mode] = {"p50": gaps[len(gaps) // 2], "mean": sum(gaps) / len(gaps),
                         "wall_ms": wall_ms}
            os.remove(cfg.model_file)
        rounds.append(got)
    rec = {"phase": "telemetry_cost", "config": CONFIG, "rows": THROUGHPUT_BATCHES * BATCH,
           "rounds": COST_ROUNDS, "gaps": list(COST_GAPS), "modes": modes}
    for stat in ("p50", "mean"):
        by_run = {m: [r[m][stat] for r in rounds] for m in modes}
        paired = {m: [r[m][stat] / r["plain"][stat] - 1.0 for r in rounds]
                  for m in modes if m != "plain"}
        rec[f"step_ms_{stat}"] = {
            "by_run": by_run,
            "median_of_runs": {m: _median(v) for m, v in by_run.items()},
            "paired_rel_diff": paired,
            "paired_median": {m: _median(v) for m, v in paired.items()},
            "resolved": {m: all(d > 0 for d in v) or all(d < 0 for d in v)
                         for m, v in paired.items()},
            "resolvable_rel_diff": {m: (max(v) - min(v)) / 2 for m, v in paired.items()},
        }
    rec["wall_ms"] = {m: [r[m]["wall_ms"] for r in rounds] for m in modes}
    emit(rec)
    return rec


def phase_telemetry_serve_predict(rng, tmp: str, train_cfg) -> None:
    """The trained baseline5 model served (2048 lines through serve_lines)
    and predicted on the card with metrics_path: kind=serving and
    kind=predict with their keys, a profile record per bucket and for
    predict_step, no steady-state compile."""
    import dataclasses

    from fast_tffm_tpu_torch.prediction import predict
    from fast_tffm_tpu_torch.serving import serve_lines

    out = {"phase": "telemetry_serve"}
    metrics = os.path.join(tmp, "telemetry_serve.jsonl")
    cfg = dataclasses.replace(train_cfg, metrics_path=metrics, serve_metrics_every_s=0.05)
    lines = _lines(rng, 2048, cfg.vocabulary_size)
    sink = io.StringIO()
    serve_lines(cfg, lines, out=sink, log=log_stderr, device="cuda")
    records = _records(metrics)
    out["kinds"] = _check_records("telemetry_serve", records)
    serving = [r for r in records if r["kind"] == "serving"]
    if not serving or serving[-1]["requests"] != len(lines) or serving[-1]["rows"] != len(lines):
        fail(f"telemetry_serve: serving records {serving[-1:]}")
    buckets = sorted(r["program"] for r in records if r["kind"] == "profile")
    if buckets != sorted(f"serve_score_b{b}" for b in cfg.serve_buckets):
        fail(f"telemetry_serve: profile records {buckets}")
    out["serving_records"] = len(serving)
    out["total_ms"] = serving[-1]["total_ms"]
    emit(out)
    metrics = os.path.join(tmp, "telemetry_predict.jsonl")
    cfg = dataclasses.replace(train_cfg, metrics_path=metrics,
                              score_path=os.path.join(tmp, "telemetry_predict.scores"))
    predict(cfg, log=log_stderr, device="cuda")
    records = _records(metrics)
    kinds = _check_records("telemetry_predict", records)
    (pred,) = [r for r in records if r["kind"] == "predict"]
    if pred["examples"] != VALID_BATCHES * BATCH or not pred["examples_per_sec"]:
        fail(f"telemetry_predict: {pred}")
    if [r["program"] for r in records if r["kind"] == "profile"] != ["predict_step"]:
        fail("telemetry_predict: no predict_step profile record")
    emit({"phase": "telemetry_predict", "kinds": kinds, "predict": pred})


def _ckpt_records(what: str, metrics: str, mode: str) -> list:
    records = _records(metrics)
    _check_records(what, records)
    ckpt = [r for r in records if r["kind"] == "ckpt"]
    if not ckpt or any(r["mode"] != mode for r in ckpt):
        fail(f"{what}: kind=ckpt modes {[r['mode'] for r in ckpt]}, all {mode!r} expected")
    return ckpt


def _stall(ckpt: list) -> dict:
    keys = ("step", "train_stall_ms", "snapshot_ms", "convert_ms", "d2h_ms", "write_ms", "bytes")
    return [{k: r[k] for k in keys} for r in ckpt]


def phase_ckpt_async(tmp: str, train_cfg) -> dict:
    """The rows run and the fused run (native text, 2 epochs, an epoch save
    each) with async_save, each against the same run saved synchronously:
    the final files bitwise equal, kind=ckpt mode full (async) and sync,
    and each save's train_stall_ms."""
    rec, launches, refs = {"phase": "ckpt_async", "config": CONFIG}, {}, {}
    for layout, extra, init in (("rows", {}, "train.init.ckpt"),
                                ("fused", FUSED, "train_fused.init.ckpt")):
        base = _b5(**extra)
        width = 1 if extra else base.factor_num + 1
        files = dict(train_files=train_cfg.train_files,
                     validation_files=train_cfg.validation_files, epoch_num=2, log_every=8)
        out = {}
        for mode in ("sync", "async"):
            metrics = os.path.join(tmp, f"ckpt_async_{layout}_{mode}.jsonl")
            cfg = _phase_cfg(base, tmp, f"ckpt_async_{layout}_{mode}", "cuda",
                             os.path.join(tmp, init), **files, metrics_path=metrics,
                             async_save=mode == "async")
            run = _run(f"ckpt_async {layout} {mode}", cfg)
            tail = "fused_tail_adagrad" if extra else "rows_tail_adagrad"
            _expect_steps(f"ckpt_async {layout} {mode}", run["launches"], 2 * TRAIN_BATCHES, tail)
            ckpt = _ckpt_records(f"ckpt_async {layout} {mode}", metrics,
                                 "full" if mode == "async" else "sync")
            out[mode] = {"saves": _stall(ckpt), "wall_ms": run["wall_ms"],
                         "examples_per_s_run": 2 * TRAIN_BATCHES * BATCH / (run["wall_ms"] / 1e3),
                         "model_file": cfg.model_file}
            launches[f"ckpt_async_{layout}_{mode}"] = run["launches"]
        _same_files(f"ckpt_async {layout}", out["async"]["model_file"],
                    out["sync"]["model_file"], width)
        refs[layout] = out["sync"].pop("model_file")
        out["async"].pop("model_file")
        rec[layout] = {**out, "bitwise": True}
    emit(rec)
    return {"launches": launches, "rows_reference": refs["rows"]}


def _window_uniques(train_path: str, vocab: int) -> list:
    """The unique-id count of each 8-batch window of the unshuffled epoch
    (windows end at batches 8, 16, 24), from the host parse."""
    import numpy as np

    from fast_tffm_tpu_torch.data.native import best_parser
    from fast_tffm_tpu_torch.data.pipeline import batch_stream

    ids = [p.ids for p, _ in batch_stream([train_path], batch_size=BATCH, vocabulary_size=vocab,
                                          max_nnz=NNZ, parser=best_parser(8))]
    return [int(np.unique(np.concatenate(ids[lo:lo + DELTA_EVERY])).size)
            for lo in range(0, TRAIN_BATCHES, DELTA_EVERY)]


def phase_ckpt_delta(tmp: str, train_cfg, async_out: dict) -> dict:
    """delta_every_steps = 8 on the rows layout, 2 epochs, at K = 1 (native
    text) and K = 8 (device cache, a graph per 8 steps): a run aborted after
    its last call leaves base@24 + deltas @32, @40, @48, which replay
    bitwise to the uninterrupted run's final file (ckpt_async's synchronous
    rows run; at K = 8 a plain K = 8 run); a run stopped within the window
    after step 16 leaves its chain head there, and --resume from it ends
    bitwise the
    uninterrupted run; each delta's rows_written is its window's unique
    ids (from the host parse)."""
    from fast_tffm_tpu_torch.checkpoint import delta_paths, read_input_cursor

    init = os.path.join(tmp, "train.init.ckpt")
    width = train_cfg.factor_num + 1
    uniques = _window_uniques(train_cfg.train_files[0], train_cfg.vocabulary_size)
    rec, launches = {"phase": "ckpt_delta", "config": CONFIG, "delta_every_steps": DELTA_EVERY,
                     "window_unique_ids": uniques}, {}
    files = dict(train_files=train_cfg.train_files, validation_files=train_cfg.validation_files,
                 epoch_num=2, log_every=8)
    for k in (1, 8):
        mode = {"device_cache": True, "binary_cache": True, "steps_per_call": 8} if k > 1 else {}
        base = _b5(**mode)
        if k == 1:
            ref = async_out["rows_reference"]  # ckpt_async's synchronous rows run
        else:
            plain = _run("ckpt_delta K=8 plain", _phase_cfg(base, tmp, "ckpt_delta_k8_plain",
                                                            "cuda", init, **files))
            launches["ckpt_delta_k8_plain"] = plain["launches"]
            ref = plain["cfg"].model_file
        metrics = os.path.join(tmp, f"ckpt_delta_k{k}.jsonl")
        whole = _run(f"ckpt_delta K={k} to the end",
                     _phase_cfg(base, tmp, f"ckpt_delta_k{k}_end", "cuda", init, **files,
                                delta_every_steps=DELTA_EVERY, metrics_path=metrics),
                     _abort_at(2 * TRAIN_BATCHES), expect_abort=True)
        end = whole["cfg"].model_file
        chain = [os.path.basename(p) for p in delta_paths(end)]
        if len(chain) != 3:
            fail(f"ckpt_delta K={k}: the chain {chain}, three deltas expected")
        # The chain head names the position inside the last epoch, (1, 24);
        # the final save the next epoch's start, (2, 0): the same batch.
        _same_files(f"ckpt_delta K={k} chain", end, ref, width, cursor=False)
        head_cursor = read_input_cursor(end)
        if (head_cursor["epoch"], head_cursor["batch_in_epoch"]) != (1, TRAIN_BATCHES):
            fail(f"ckpt_delta K={k}: the chain head's cursor {head_cursor}")
        records = _records(metrics)
        _check_records(f"ckpt_delta K={k}", records)
        deltas = [r for r in records if r["kind"] == "ckpt" and r["mode"] == "delta"]
        (summary,) = [r for r in records if r["kind"] == "summary"]
        for r in deltas:
            want = uniques[((r["step"] - 1) % TRAIN_BATCHES) // DELTA_EVERY]
            if r["rows_written"] != want:
                fail(f"ckpt_delta K={k}: the delta at step {r['step']} wrote "
                     f"{r['rows_written']} rows, its window has {want} unique ids")
        # Stopped inside the call that ends at step 16 (K = 8) or right
        # after step 18 (K = 1): either way the chain head is the delta at 16.
        cut = _run(f"ckpt_delta K={k} stopped",
                   _phase_cfg(base, tmp, f"ckpt_delta_k{k}_cut", "cuda", init, **files,
                              delta_every_steps=DELTA_EVERY),
                   _abort_at(9 if k > 1 else 18), expect_abort=True)
        head = cut["cfg"].model_file
        cursor = read_input_cursor(head)
        if len(delta_paths(head)) != 1 or (cursor["epoch"], cursor["batch_in_epoch"]) != (0, 16):
            fail(f"ckpt_delta K={k}: after the stop {delta_paths(head)} and cursor {cursor}")
        resumed = _run(f"ckpt_delta K={k} resumed", cut["cfg"])
        seek = "resuming input at epoch 0, batch 16 (exact-position cursor)"
        if seek not in resumed["log"]:
            fail(f"ckpt_delta K={k}: the resume did not seek: {resumed['log'][:4]}")
        _same_files(f"ckpt_delta K={k} resumed", head, ref, width)
        for what, r, steps in (("to the end", whole, 48), ("stopped", cut, 16 if k > 1 else 18),
                               ("resumed", resumed, 32)):
            _expect_steps(f"ckpt_delta K={k} {what}", r["launches"], steps)
        out = {"chain": chain, "deltas": [{k2: r[k2] for k2 in ("step", "rows_written", "bytes",
                                                                 "train_stall_ms", "d2h_ms",
                                                                 "write_ms")} for r in deltas],
               "ckpt_summary": {k2: v for k2, v in summary.items() if k2.startswith("ckpt_")},
               "bitwise_chain": True, "bitwise_resumed": True, "resume": seek,
               "wall_ms": {"to_the_end": whole["wall_ms"], "stopped": cut["wall_ms"],
                           "resumed": resumed["wall_ms"]}}
        for run, r in (("end", whole), ("stopped", cut), ("resumed", resumed)):
            launches[f"ckpt_delta_k{k}_{run}"] = r["launches"]
        rec[f"k{k}"] = out
    emit(rec)
    return launches


def phase_ckpt_ffm(tmp: str, ffm: dict) -> dict:
    """configs/baseline3_ffm_avazu.cfg at full width (a 746 MB state) with the
    16-step cut, its epoch save synchronous and async: the final files
    bitwise equal; each save's train_stall_ms and the whole run's ex/s
    (numbers to record), in turns (sync, async, async, sync)."""
    from fast_tffm_tpu_torch.config import build_model

    cfg0 = ffm["cuda_cfg"]
    row_dim = build_model(cfg0).row_dim
    width = row_dim if cfg0.adagrad_accumulator == "element" else 1
    rec = {"phase": "ckpt_ffm", "config": ZOO["ffm"][0], "row_dim": row_dim,
           "state_bytes": cfg0.vocabulary_size * (row_dim + width) * 4}
    launches, files = {}, {}
    for i, mode in enumerate(("sync", "async", "async", "sync")):
        metrics = os.path.join(tmp, f"ckpt_ffm_{i}.jsonl")
        cfg = _phase_cfg(cfg0, tmp, f"ckpt_ffm_{i}", "cuda", ffm["init"],
                         metrics_path=metrics, async_save=mode == "async")
        run = _run(f"ckpt_ffm {mode}", cfg)
        if run["launches"]["rows_tail_adagrad"] != FFM_STEPS:
            fail(f"ckpt_ffm {mode}: {run['launches']} for {FFM_STEPS} steps")
        ckpt = _ckpt_records(f"ckpt_ffm {mode}", metrics, "full" if mode == "async" else "sync")
        rec.setdefault(mode, []).append({
            "saves": _stall(ckpt), "wall_ms": run["wall_ms"],
            "examples_per_s_run": FFM_STEPS * cfg.batch_size / (run["wall_ms"] / 1e3)})
        launches[f"ckpt_ffm_{i}_{mode}"] = run["launches"]
        files.setdefault(mode, cfg.model_file)
    _same_files("ckpt_ffm", files["async"], files["sync"], width)
    rec["bitwise"] = True
    emit(rec)
    return launches



SERVE_PROBE = 64  # probe rows: one bucket-64 flush in every engine that scores them
SERVE_FRAME = 64  # rows per binary frame on the socket tier
SERVE_WAIT_S = 120.0  # bound of every wait on the socket tier


def _land(src: str, dst: str) -> None:
    """Publish ``src`` at ``dst`` as a writer does: a copy, then a rename."""
    import shutil

    shutil.copy(src, dst + ".landing")
    os.replace(dst + ".landing", dst)


def _tear(path: str, member: str) -> None:
    """Garbage bytes inside ``member`` of the npz at ``path`` (a write torn
    mid-file): the step still reads, the member fails its CRC check."""
    import struct
    import zipfile

    with zipfile.ZipFile(path) as z:
        off = z.getinfo(member).header_offset
    with open(path, "r+b") as f:
        f.seek(off + 26)
        name_len, extra_len = struct.unpack("<HH", f.read(4))
        f.seek(off + 30 + name_len + extra_len + 128)
        chunk = f.read(64)
        f.seek(off + 30 + name_len + extra_len + 128)
        f.write(bytes(b ^ 0xFF for b in chunk))


def _delta_rows(path: str) -> int:
    import numpy as np

    with np.load(path) as z:
        return int(z["delta_idx"].shape[0])


def _probe_block(rng, vocab: int):
    import numpy as np

    from fast_tffm_tpu_torch.data.libsvm import parse_lines

    parsed = parse_lines(_lines(rng, SERVE_PROBE, vocab), vocabulary_size=vocab, max_nnz=NNZ)
    return parsed.ids.astype(np.int32), parsed.vals


def _block_scores(engine, probe):
    import numpy as np

    st, sc = engine.submit_block(*probe).result(timeout=60)
    if st.any():
        fail(f"a probe block came back with statuses {sorted(set(st.tolist()))}")
    return np.asarray(sc)


def _fresh_scores(cfg, probe, ref_launches: list):
    """A fresh card engine restored from what ``cfg.model_file`` holds now;
    its forward launches (a reference, not the path under test) are added
    to ``ref_launches[0]``."""
    import dataclasses

    from fast_tffm_tpu_torch.ops.anova import anova_inter
    from fast_tffm_tpu_torch.serving import ServingEngine

    cfg = dataclasses.replace(cfg, serve_reload_interval_s=0.0, metrics_path="")
    before = anova_inter.launches
    with ServingEngine(cfg, log=lambda *_: None, device="cuda") as eng:
        out = _block_scores(eng, probe)
    ref_launches[0] += anova_inter.launches - before
    return out


def _until_step(engine, step: int, probe, what: str, timeout: float = 30.0) -> float:
    """Flush probes until ``engine`` serves ``step`` (a swap happens at a
    flush); returns the seconds waited."""
    t0 = time.perf_counter()
    while engine.step != step:
        if time.perf_counter() - t0 > timeout:
            fail(f"{what}: the engine still serves step {engine.step} after {timeout}s "
                 f"(expected {step})")
        _block_scores(engine, probe)
        time.sleep(0.002)
    return time.perf_counter() - t0


def _serve_reload_orbax(tmp: str, cfg, probe, states, ref_launches: list) -> dict:
    """An engine started from an orbax directory (``states[0]`` saved there)
    reloads it in full once ``states[1]`` is saved over it (the sidecar step
    and the renamed directory move the signature); each served state's
    scores are a fresh card engine's, bitwise."""
    import dataclasses

    import numpy as np

    from fast_tffm_tpu_torch.checkpoint import checkpoint_signature, save_checkpoint
    from fast_tffm_tpu_torch.serving import ServingEngine

    odir = os.path.join(tmp, "serve_reload.orbax")
    ocfg = dataclasses.replace(cfg, model_file=odir, serve_reload_interval_s=0.0,
                               metrics_path="")
    save_checkpoint(odir, states[0], "orbax")
    with ServingEngine(ocfg, log=log_stderr, device="cuda") as eng:
        got = _block_scores(eng, probe)
        if eng.step != states[0].step or not np.array_equal(
                got, _fresh_scores(ocfg, probe, ref_launches)):
            fail(f"serve_reload orbax: the first state (step {eng.step}) is not a fresh "
                 "engine's")
        sig = checkpoint_signature(odir)
        t0 = time.perf_counter()
        save_checkpoint(odir, states[1], "orbax")
        save_ms = 1e3 * (time.perf_counter() - t0)
        if checkpoint_signature(odir) == sig:
            fail("serve_reload orbax: the second save left the signature unchanged")
        t0 = time.perf_counter()
        status = eng.reload_once()["status"]
        reload_ms = 1e3 * (time.perf_counter() - t0)
        if status != "staged":
            fail(f"serve_reload orbax: reload_once gave {status}")
        _until_step(eng, states[1].step, probe, "serve_reload orbax")
        got = _block_scores(eng, probe)
        snap = eng.metrics_snapshot()
    if not np.array_equal(got, _fresh_scores(ocfg, probe, ref_launches)):
        fail("serve_reload orbax: the reloaded scores are not a fresh engine's")
    return {"steps": [states[0].step, states[1].step], "bitwise_fresh": True,
            "reloads": snap["reloads"], "reload_failures": snap["reload_failures"],
            "save_ms": save_ms, "reload_ms": reload_ms}


def phase_serve_reload(rng, tmp: str, train_cfg, fused_cfg) -> dict:
    """Hot reload at full width on the card.  A card training run (native
    text, 2 epochs, delta_every_steps = 8, async_save) aborted after its
    last call leaves base@24 + deltas @32, @40, @48.  An engine with
    reload_interval_s 0.2 serves the base, and the phase lands, one at a
    time (copy + rename), each delta, then a new full save (the fused run's
    step-24 file), then a torn delta (reload_max_retries 3): after each
    stage the 64-row probe's scores equal, bitwise, a fresh card engine
    restored from the same chain head; the torn file is counted, given up
    on, and the scores stay.  Then a racing engine (watcher off): a flush
    loop while reload_once applies delta 1, every flush bitwise one head or
    the other; the apply and a full reload timed."""
    import dataclasses
    import threading

    import numpy as np
    import torch

    from fast_tffm_tpu_torch.checkpoint import checkpoint_save_id, delta_paths, save_delta
    from fast_tffm_tpu_torch.serving import ServingEngine

    files = dict(train_files=train_cfg.train_files, validation_files=train_cfg.validation_files,
                 epoch_num=2, log_every=8)
    writer = _run("serve_reload writer",
                  _phase_cfg(_b5(), tmp, "serve_reload_w", "cuda",
                             os.path.join(tmp, "train.init.ckpt"), **files,
                             delta_every_steps=DELTA_EVERY, async_save=True),
                  _abort_at(2 * TRAIN_BATCHES), expect_abort=True)
    _expect_steps("serve_reload writer", writer["launches"], 2 * TRAIN_BATCHES)
    base = writer["cfg"].model_file
    deltas = delta_paths(base)
    if len(deltas) != 3:
        fail(f"serve_reload: the writer left {deltas}, three deltas expected")
    served = os.path.join(tmp, "serve_reload.ckpt")
    _land(base, served)
    metrics = os.path.join(tmp, "serve_reload.jsonl")
    cfg = _b5(model_file=served, serve_reload_interval_s=0.2, serve_reload_max_retries=3,
              metrics_path=metrics)
    probe = _probe_block(rng, cfg.vocabulary_size)
    heads, stages, ref_launches = {}, [], [0]
    _zero_counters()
    eng = ServingEngine(cfg, log=log_stderr, device="cuda")
    try:
        heads["base"] = _fresh_scores(cfg, probe, ref_launches)
        got = _block_scores(eng, probe)
        if eng.step != TRAIN_BATCHES or not np.array_equal(got, heads["base"]):
            fail(f"serve_reload: the base (step {eng.step}) differs from a fresh engine's")
        plan = [(f"delta_{i + 1}", d, TRAIN_BATCHES + DELTA_EVERY * (i + 1))
                for i, d in enumerate(deltas)]
        plan.append(("full", fused_cfg.model_file, TRAIN_BATCHES))
        for name, src, step in plan:
            if name == "full":  # a full save unlinks the chain (newest first,
                # as checkpoint.save_checkpoint does), then publishes
                failed_before_reset = eng.metrics_snapshot()["reload_failures"]
                if failed_before_reset:
                    fail(f"serve_reload: {failed_before_reset} failed reloads before the "
                         "full save")
                for dp in reversed(delta_paths(served)):
                    os.remove(dp)
                t_land = time.perf_counter()
                _land(src, served)
            else:
                t_land = time.perf_counter()
                _land(src, f"{served}.{src.rsplit('.', 2)[-2]}.npz")
            _until_step(eng, step, probe, f"serve_reload {name}")
            landed_to_scored = 1e3 * (time.perf_counter() - t_land)
            got = _block_scores(eng, probe)
            heads[name] = _fresh_scores(cfg, probe, ref_launches)
            if not np.array_equal(got, heads[name]):
                err = float(np.abs(got - heads[name]).max())
                fail(f"serve_reload {name}: scores differ from a fresh engine's by {err}")
            stages.append({"stage": name, "step": step, "bitwise_fresh": True,
                           "landed_to_scored_ms": landed_to_scored})
        # A tick that lists the chain while the reset unlinks it can find a
        # file gone (FileNotFoundError): counted and retried, as in the JAX
        # engine.  Those are reported apart from the torn delta's.
        reset_failures = eng.metrics_snapshot()["reload_failures"]
        # A torn delta chained to the new base: counted, given up on after 3.
        torn = f"{served}.delta-0001.npz"
        rows = np.arange(0, cfg.vocabulary_size, 7)
        out, _, _ = save_delta(
            served + ".tmp-torn", 1, idx=rows,
            table_rows=np.zeros((rows.size, 1 + cfg.factor_num), np.float32),
            accum_rows=np.zeros((rows.size, 1 + cfg.factor_num), np.float32),
            dense_leaves=[], dense_accum_leaves=[], step=TRAIN_BATCHES + 1,
            parent_sig=checkpoint_save_id(served))
        _tear(out, "table_rows.npy")
        os.replace(out, torn)
        t0 = time.perf_counter()
        while eng.metrics_snapshot()["reload_giveups"] < 1:
            if time.perf_counter() - t0 > 30:
                fail(f"serve_reload torn: no give-up in 30 s: {eng.metrics_snapshot()}")
            time.sleep(0.05)
        got = _block_scores(eng, probe)
        if eng.step != TRAIN_BATCHES or not np.array_equal(got, heads["full"]):
            fail("serve_reload torn: the torn delta moved the serving state")
        stages.append({"stage": "torn_delta", "step": eng.step, "bitwise_fresh": True,
                       "given_up_after_s": time.perf_counter() - t0})
        snap = eng.metrics_snapshot()
    finally:
        eng.close()
    torch.cuda.synchronize()
    launches = _wrapper_counts()
    launches["anova_fwd"] -= ref_launches[0]  # the watcher engine's own
    counts = {k: snap[k] for k in ("reloads", "delta_reloads", "reload_failures",
                                   "reload_giveups")}
    counts["torn_failures"] = counts["reload_failures"] - reset_failures
    counts["chain_reset_failures"] = reset_failures
    if {k: counts[k] for k in ("reloads", "delta_reloads", "torn_failures", "reload_giveups")} \
            != {"reloads": 1, "delta_reloads": 3, "torn_failures": 3, "reload_giveups": 1}:
        fail(f"serve_reload: counters {counts}")
    fresh = [r for r in _records(metrics) if r["kind"] == "freshness"]
    if [r["mode"] for r in fresh] != ["delta", "delta", "delta", "full"]:
        fail(f"serve_reload: freshness records {fresh}")
    if launches["anova_fwd"] == 0:
        fail("serve_reload: the engine never launched the anova_fwd kernel")

    # The race: a flush loop on a watcher-off engine while reload_once
    # applies delta 1 to a copy of the table; then a full reload, timed.
    raced = os.path.join(tmp, "serve_race.ckpt")
    _land(base, raced)
    rcfg = dataclasses.replace(cfg, model_file=raced, serve_reload_interval_s=0.0,
                               metrics_path="")
    seen, stop = [], threading.Event()
    with ServingEngine(rcfg, log=log_stderr, device="cuda") as race:

        def loop():
            while not stop.is_set():
                seen.append(_block_scores(race, probe))

        t = threading.Thread(target=loop)
        t.start()
        try:
            while len(seen) < 5:
                time.sleep(0.001)
            _land(deltas[0], f"{raced}.delta-0001.npz")
            t0 = time.perf_counter()
            status = race.reload_once()["status"]
            apply_ms = 1e3 * (time.perf_counter() - t0)
            n = len(seen)
            t0 = time.perf_counter()
            while (race.step != TRAIN_BATCHES + DELTA_EVERY or len(seen) < n + 5) and \
                    time.perf_counter() - t0 < 30:
                time.sleep(0.001)
        finally:
            stop.set()
            t.join(timeout=60)
        if t.is_alive() or status != "staged_delta":
            fail(f"serve_reload race: status {status}, loop alive {t.is_alive()}")
        kinds = [0 if np.array_equal(s, heads["base"]) else
                 1 if np.array_equal(s, heads["delta_1"]) else -1 for s in seen]
        if -1 in kinds or kinds != sorted(kinds) or 1 not in kinds:
            fail(f"serve_reload race: flushes scored {kinds} (0 base, 1 delta head, -1 a mix)")
        for dp in reversed(delta_paths(raced)):
            os.remove(dp)
        _land(fused_cfg.model_file, raced)
        t0 = time.perf_counter()
        full_status = race.reload_once()["status"]
        full_ms = 1e3 * (time.perf_counter() - t0)
        if full_status != "staged":
            fail(f"serve_reload race: the full reload gave {full_status}")
    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
    from fast_tffm_tpu_torch.config import build_model

    cpu = torch.device("cpu")
    orbax = _serve_reload_orbax(tmp, cfg, probe, [
        restore_checkpoint(fused_cfg.model_file, cpu, accum_width=1),
        restore_checkpoint(base, cpu, accum_width=build_model(cfg).row_dim)], [0])
    rec = {
        "phase": "serve_reload", "config": CONFIG, "reload_interval_s": 0.2,
        "reload_max_retries": 3, "chain": [os.path.basename(d) for d in deltas],
        "stages": stages, "counts": counts, "anova_launches": launches["anova_fwd"],
        "freshness_applied_ms": snap["freshness_applied_ms"],
        "freshness_scored_ms": snap["freshness_scored_ms"],
        "freshness_note": "from the writer's publish stamps: includes the replay's delay",
        "race": {"flushes": len(seen), "on_base": kinds.count(0), "on_delta": kinds.count(1),
                 "bitwise_one_head": True, "delta_stage_ms": apply_ms,
                 "delta_rows": _delta_rows(deltas[0]),
                 "full_stage_ms": full_ms},
        "writer_wall_ms": writer["wall_ms"],
        "orbax": orbax,
    }
    emit(rec)
    return {"served_base": base, "deltas": deltas, "heads": heads, "probe": probe,
            "anova_launches": launches["anova_fwd"]}


def _percentiles(xs) -> dict:
    import numpy as np

    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)), "p99": float(np.percentile(a, 99)),
            "max": float(a.max())}


def _pin(port: int, replica: int, on_result=None, tries: int = 6):
    """A FrameConnection whose affinity hello placed it on ``replica``."""
    from fast_tffm_tpu_torch.serving.client import FrameConnection

    for _ in range(tries):
        fc = FrameConnection(port, timeout=60, on_result=on_result)
        if fc.replica == replica:
            return fc
        fc.close()
    fail(f"serve_socket: no hello placed a connection on replica {replica}")


def _send_frames(fc, ids, vals, rids, sent: dict, deadlines_ms=None) -> None:
    for a in range(0, len(rids), SERVE_FRAME):
        r = rids[a:a + SERVE_FRAME]
        sent[int(r[0])] = time.perf_counter()
        fc.send_batch(r, ids[a:a + SERVE_FRAME], vals[a:a + SERVE_FRAME],
                      deadlines_ms=None if deadlines_ms is None else
                      [deadlines_ms] * len(r))


def _frame_results(fc, rids, what: str) -> tuple:
    import numpy as np

    missing = fc.wait_answered(rids, SERVE_WAIT_S)
    if missing:
        fail(f"{what}: {len(missing)} rows never answered")
    status = [fc.results[int(r)][0] for r in rids]
    return status, np.array([fc.results[int(r)][1] for r in rids], np.float32)


def phase_serve_socket(rng, tmp: str, reload_out: dict) -> dict:
    """The socket tier on the card: ``python -m fast_tffm_tpu_torch.cli serve
    <cfg> --port 0`` with replicas = 2, serving the serve_reload chain at
    delta 2 (@40).  serve_socket: 4096 lines of 11 uniform ids over two
    affinity-pinned FrameConnections (binary frames of 64 rows, all
    pipelined) and once over JSONL; every score against the card's
    in-process engine (64-row blocks) within atol 1e-6 (a flush that
    coalesces frames scores at another bucket, which may move the last
    float32 bit) and serve_lines' printed value; each replica's stats
    (device cuda, B1 launches during the traffic).  serve_failover: the
    same stream with replica 0 SIGKILLed midway (every row answered, the
    scores serve_socket's), its restart and MTTR; delta 3 landed: one
    reload fan-out, staged_delta once per replica, each replica's probe
    bitwise serve_reload's head @48; a 200 ms x 4 slow replica under
    50 ms row deadlines: typed deadline answers, none hung."""
    import signal

    import numpy as np

    from fast_tffm_tpu_torch.data.libsvm import parse_lines
    from fast_tffm_tpu_torch.serving import ServingEngine, serve_lines
    from fast_tffm_tpu_torch.serving.client import ServeConnection, spawn_serve

    served = os.path.join(tmp, "serve_socket.ckpt")
    _land(reload_out["served_base"], served)
    for i, dp in enumerate(reload_out["deltas"][:2]):
        _land(dp, f"{served}.delta-{i + 1:04d}.npz")
    cfg_path = _write_ini(os.path.join(tmp, "serve_socket.cfg"),
                          General={"model_file": served},
                          Serving={"replicas": 2, "reload_interval_s": 0.2},
                          Resilience={"restart_backoff_s": 0.5})
    from fast_tffm_tpu_torch.config import load_config

    cfg = load_config(cfg_path)
    lines = _lines(rng, SERVE_LINES, cfg.vocabulary_size)
    parsed = parse_lines(lines, vocabulary_size=cfg.vocabulary_size, max_nnz=NNZ)
    ids, vals = parsed.ids.astype(np.int32), parsed.vals
    # The card's in-process references: 64-row blocks, and serve_lines.
    import dataclasses

    ref_cfg = dataclasses.replace(cfg, serve_reload_interval_s=0.0)
    with ServingEngine(ref_cfg, log=lambda *_: None, device="cuda") as eng:
        ref = np.concatenate([_block_scores(eng, (ids[a:a + 64], vals[a:a + 64]))
                              for a in range(0, SERVE_LINES, 64)])
    out = io.StringIO()
    serve_lines(ref_cfg, lines, out=out, log=lambda *_: None, device="cuda")
    printed = np.array([float(s) for s in out.getvalue().split()], np.float64)

    def against_ref(got, what: str) -> dict:
        if got.shape != ref.shape or not np.isfinite(got).all():
            fail(f"{what}: {got.shape} scores, {SERVE_LINES} finite expected")
        err = float(np.abs(got.astype(np.float64) - ref).max())
        perr = float(np.abs(got.astype(np.float64) - printed).max())
        if err > ATOL or perr > ATOL + 5e-7:
            fail(f"{what}: scores differ from the in-process engine's by {err} "
                 f"(serve_lines' printed by {perr})")
        return {"max_abs_err": err, "bitwise_share": float(np.mean(got == ref)),
                "max_abs_err_vs_printed": perr}

    t0 = time.perf_counter()
    proc, port = spawn_serve(cfg_path, device="cuda", timeout_s=240, log=log_stderr)
    startup_s = time.perf_counter() - t0
    pids = []
    try:
        ops = ServeConnection(port, timeout=60)
        before = ops.request({"op": "stats"}, timeout=60)
        pids = [r["pid"] for r in before["replicas"]]
        # serve_socket, frames: two connections, one per replica, all frames
        # of each pipelined at once.
        done_t: dict = {}

        def stamp(rid, st, sc):
            done_t[rid] = time.perf_counter()

        fcs = [_pin(port, 0, stamp), _pin(port, 1, stamp)]
        sent: dict = {}
        half = SERVE_LINES // 2
        t0 = time.perf_counter()
        for i, fc in enumerate(fcs):
            rids = np.arange(i * half, (i + 1) * half, dtype=np.uint32)
            _send_frames(fc, ids[rids], vals[rids], rids, sent)
        status, frame_scores = [], []
        for i, fc in enumerate(fcs):
            rids = np.arange(i * half, (i + 1) * half, dtype=np.uint32)
            st, sc = _frame_results(fc, rids, "serve_socket frames")
            status += st
            frame_scores.append(sc)
        frames_s = time.perf_counter() - t0
        frame_scores = np.concatenate(frame_scores)
        if set(status) != {"ok"}:
            fail(f"serve_socket frames: statuses {sorted(set(status))}")
        frame_lat = [1e3 * (done_t[r] - sent[r - r % SERVE_FRAME]) for r in range(SERVE_LINES)]
        frame_rec = {"lines_per_s": SERVE_LINES / frames_s, "seconds": frames_s,
                     "latency_ms": _percentiles(frame_lat), **against_ref(frame_scores, "frames")}
        # serve_socket, JSONL through the front end and the router.
        jsent, jdone = {}, {}

        def jstamp(msg, meta):
            jdone[msg.get("id")] = time.perf_counter()
            return False  # keep it in responses too

        jconn = ServeConnection(port, timeout=60, on_response=jstamp)
        t0 = time.perf_counter()
        for i, ln in enumerate(lines):
            jsent[i] = time.perf_counter()
            jconn.send({"id": i, "line": ln})
        missing = jconn.wait_answered(range(SERVE_LINES), SERVE_WAIT_S)
        jsonl_s = time.perf_counter() - t0
        if missing:
            fail(f"serve_socket jsonl: {len(missing)} lines never answered")
        bad = [jconn.responses[i] for i in range(SERVE_LINES) if "score" not in jconn.responses[i]]
        if bad:
            fail(f"serve_socket jsonl: {len(bad)} errors, first {bad[0]}")
        jsonl_scores = np.array([jconn.responses[i]["score"] for i in range(SERVE_LINES)],
                                np.float32)
        jsonl_rec = {"lines_per_s": SERVE_LINES / jsonl_s, "seconds": jsonl_s,
                     "latency_ms": _percentiles([1e3 * (jdone[i] - jsent[i])
                                                 for i in range(SERVE_LINES)]),
                     **against_ref(jsonl_scores, "jsonl")}
        after = ops.request({"op": "stats"}, timeout=60)
        per_replica = {}
        for r in ("0", "1"):
            e0, e1 = before["engines"][r], after["engines"][r]
            if not str(e1.get("device", "")).startswith("cuda"):
                fail(f"serve_socket: replica {r} runs on {e1.get('device')}")
            launched = e1["launches"]["anova_fwd"] - e0["launches"]["anova_fwd"]
            if launched <= 0:
                fail(f"serve_socket: replica {r} launched the anova_fwd kernel {launched} times")
            per_replica[r] = {"device": e1["device"], "anova_launches": launched,
                              "warmup_anova_launches": e0["launches"]["anova_fwd"],
                              "requests": e1["engine"]["requests"],
                              "flushes": e1["engine"]["flushes"],
                              "batch_occupancy": e1["engine"]["batch_occupancy"],
                              "compute_ms": e1["engine"]["compute_ms"],
                              "steady_compiles": e1["steady_compiles"]}
        emit({"phase": "serve_socket", "config": CONFIG, "replicas": 2, "lines": SERVE_LINES,
              "frame_rows": SERVE_FRAME, "startup_s": startup_s, "frames": frame_rec,
              "jsonl": jsonl_rec, "atol": ATOL, "replica_stats": per_replica,
              "router": {k: after[k] for k in ("failovers", "failed_unanswerable",
                                               "reload_fanouts")}})

        # serve_failover: the same stream, replica 0 SIGKILLed midway.
        fc = _pin(port, 0)
        jconn2 = ServeConnection(port, timeout=60)
        rids = np.arange(10_000, 10_000 + SERVE_LINES, dtype=np.uint32)
        fsent: dict = {}
        t0 = time.perf_counter()
        _send_frames(fc, ids[:half], vals[:half], rids[:half], fsent)
        for i in range(half):
            jconn2.send({"id": i, "line": lines[i]})
        os.kill(pids[0], signal.SIGKILL)
        t_kill = time.perf_counter()
        _send_frames(fc, ids[half:], vals[half:], rids[half:], fsent)
        for i in range(half, SERVE_LINES):
            jconn2.send({"id": i, "line": lines[i]})
        fst, fsc = _frame_results(fc, rids, "serve_failover frames")
        jmissing = jconn2.wait_answered(range(SERVE_LINES), SERVE_WAIT_S)
        if jmissing:
            fail(f"serve_failover jsonl: {len(jmissing)} lines never answered")
        answered_s = time.perf_counter() - t0
        ok = np.array([s == "ok" for s in fst])
        ferr = float(np.abs(fsc[ok] - frame_scores[ok]).max()) if ok.any() else None
        jres = [jconn2.responses[i] for i in range(SERVE_LINES)]
        jok = np.array(["score" in r for r in jres])
        jsc = np.array([r.get("score", 0.0) for r in jres], np.float32)
        jerr = float(np.abs(jsc[jok] - jsonl_scores[jok]).max()) if jok.any() else None
        if (ferr is not None and ferr > ATOL) or (jerr is not None and jerr > ATOL):
            fail(f"serve_failover: scores moved by {ferr} (frames) / {jerr} (jsonl)")
        codes = {}
        for s in fst:
            codes[f"frame_{s}"] = codes.get(f"frame_{s}", 0) + 1
        for r in jres:
            k = "jsonl_ok" if "score" in r else f"jsonl_{r.get('code')}"
            codes[k] = codes.get(k, 0) + 1
        if any(k.endswith(("bad_request", "None")) for k in codes):
            fail(f"serve_failover: answers {codes}")

        def ping():
            return ops.request({"op": "ping"}, timeout=60)

        t0 = time.perf_counter()
        while True:
            snap = ping()
            if snap["replicas"][0]["state"] == "healthy" and snap["mttr_s"]:
                break
            if time.perf_counter() - t0 > SERVE_WAIT_S:
                fail(f"serve_failover: replica 0 not back: {snap['replicas']}")
            time.sleep(0.2)
        if snap["replicas"][0]["restarts"] != 1 or len(snap["mttr_s"]) != 1:
            fail(f"serve_failover: restarts {snap['replicas']} mttr {snap['mttr_s']}")
        pids = [r["pid"] for r in snap["replicas"]]
        # Delta 3 lands: one fan-out, staged_delta once per replica.
        _land(reload_out["deltas"][2], f"{served}.delta-0003.npz")
        t_land = time.perf_counter()
        while True:
            snap = ping()
            if all(r["reload_acks"] >= 1 for r in snap["replicas"]):
                break
            if time.perf_counter() - t_land > SERVE_WAIT_S:
                fail(f"serve_failover: reload acks {snap['replicas']}")
            time.sleep(0.05)
        acked_ms = 1e3 * (time.perf_counter() - t_land)
        probes = {}
        for r in (0, 1):
            pfc = _pin(port, r)
            prid = np.arange(20_000, 20_000 + SERVE_PROBE, dtype=np.uint32)
            pfc.send_batch(prid, *reload_out["probe"])
            pst, psc = _frame_results(pfc, prid, f"serve_failover probe r{r}")
            pfc.close()
            if set(pst) != {"ok"} or not np.array_equal(psc, reload_out["heads"]["delta_3"]):
                err = float(np.abs(psc - reload_out["heads"]["delta_3"]).max())
                fail(f"serve_failover: replica {r}'s probe after delta 3 differs from "
                     f"serve_reload's head by {err} ({sorted(set(pst))})")
            probes[str(r)] = {"bitwise_serve_reload_head": True}
        stats = ops.request({"op": "stats"}, timeout=60)
        snap = ping()
        for r in ("0", "1"):
            e = stats["engines"][r]["engine"]
            if e["delta_reloads"] != 1 or e["reloads"] != 0 or e["reload_failures"] != 0:
                fail(f"serve_failover: replica {r} reload counters {e}")
        if snap["reload_fanouts"] != 1 or [r["reload_acks"] for r in snap["replicas"]] != [1, 1]:
            fail(f"serve_failover: fan-outs {snap['reload_fanouts']}, acks "
                 f"{[r['reload_acks'] for r in snap['replicas']]}")
        # A slow replica under 50 ms row deadlines: typed deadline answers.
        sfc = _pin(port, 1)
        ack = ops.request({"op": "slow", "replica": 1, "ms": 200, "flushes": 4}, timeout=60)
        srids = np.arange(30_000, 30_000 + 8 * SERVE_FRAME, dtype=np.uint32)
        # One frame first (its flush sleeps 200 ms), the rest during the sleep.
        _send_frames(sfc, ids[:SERVE_FRAME], vals[:SERVE_FRAME], srids[:SERVE_FRAME], {},
                     deadlines_ms=50.0)
        time.sleep(0.02)
        _send_frames(sfc, ids[SERVE_FRAME:srids.size], vals[SERVE_FRAME:srids.size],
                     srids[SERVE_FRAME:], {}, deadlines_ms=50.0)
        sst, _ = _frame_results(sfc, srids, "serve_failover slow")
        slow_codes = {s: sst.count(s) for s in set(sst)}
        if not slow_codes.get("deadline") or set(slow_codes) - {"ok", "deadline"}:
            fail(f"serve_failover slow: answers {slow_codes}")
        # Drain the injected slowness: single rows without deadlines.
        drid = np.arange(40_000, 40_004, dtype=np.uint32)
        for i, r in enumerate(drid):
            sfc.send_batch(drid[i:i + 1], ids[i:i + 1], vals[i:i + 1])
        _frame_results(sfc, drid, "serve_failover drain")
        emit({"phase": "serve_failover", "config": CONFIG, "lines": SERVE_LINES,
              "killed_replica": 0, "answered": True, "answered_s": answered_s,
              "kill_at_s": t_kill - fsent[10_000], "answers": codes,
              "frame_failovers": fc.failovers, "max_abs_err_frames": ferr,
              "max_abs_err_jsonl": jerr,
              "bitwise_frames": bool(ferr == 0.0), "bitwise_jsonl": bool(jerr == 0.0),
              "restarts": snap["replicas"][0]["restarts"], "mttr_s": snap["mttr_s"],
              "router": {k: snap[k] for k in ("failovers", "failed_unanswerable",
                                              "reload_fanouts", "reload_retries")},
              "reload": {"delta": os.path.basename(reload_out["deltas"][2]),
                         "landed_to_acked_ms": acked_ms, "reload_acks": [1, 1],
                         "staged_delta_per_replica": [1, 1], "probes": probes,
                         "freshness_staged_ms": snap["freshness_staged_ms"]},
              "slow": {"ack": ack.get("ok"), "ms": 200, "flushes": 4, "deadline_ms": 50,
                       "answers": slow_codes}})
        for c in (*fcs, fc, sfc, jconn, jconn2, ops):
            c.close()
        return {f"serve_socket_r{r}": per_replica[r]["anova_launches"] for r in ("0", "1")}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        for pid in pids:  # replicas the front end could not close
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass


# --- fault-tolerant and online training ----------------------------------------

ROLLBACK_PLANS = {1: "nan@30:31", 8: "nan@30:33"}  # the K = 8 grid's call ends at 32
SUPERVISED_PLANS = ("kill@18,torn_delta@2,io_error@3", "kill_publish@2")
FOLLOW_PLAN = "stream_stall@1,append_torn@3"  # executed by the stream's writer
ACCUM_RESTART_STEPS = 16


def _armed(plan: str, model_file: str, keep: str, after: int, stamps: list):
    """Arms the fault plan ``plan`` in this process and returns a step hook
    that stamps (step, host clock) after every call and, at the first call
    past step ``after``, copies ``model_file`` (the epoch-0 save) to
    ``keep``; then the plan's own hook."""
    import shutil

    from fast_tffm_tpu_torch.resilience import FaultPlan, install_faults

    inj = install_faults(FaultPlan.parse(plan))
    if os.path.exists(keep):
        os.remove(keep)
    stamps.clear()

    def hook(step):
        stamps.append((step, time.perf_counter()))
        if step > after and not os.path.exists(keep):
            shutil.copy(model_file, keep)
        inj.step_hook(step)

    return hook


def _rollback_gap_ms(stamps: list) -> float | None:
    """Host ms from the call after which the non-finite loss was found to
    the first call of the run that re-entered (the stamp whose step does
    not grow): the check, the failed run's close, the restore, the seek
    and one call."""
    for (s0, t0), (s1, t1) in zip(stamps, stamps[1:]):
        if s1 <= s0:
            return 1e3 * (t1 - t0)
    return None


def _skip_reference(what: str, cfg, keep: str, epoch: int, batch: int, width: int):
    """The kept epoch-0 checkpoint with its cursor moved to (``epoch``,
    ``batch``), resumed by ``cfg`` with no fault plan and no rollback: the
    run a rollback to that checkpoint and skip must equal bitwise."""
    import dataclasses

    from fast_tffm_tpu_torch.checkpoint import read_input_cursor, save_checkpoint

    ref_file = keep + ".ref"
    cursor = dict(read_input_cursor(keep), epoch=epoch, batch_in_epoch=batch)
    save_checkpoint(ref_file, _restored(keep, width), cursor=cursor)
    ref_cfg = dataclasses.replace(cfg, model_file=ref_file, metrics_path="", on_nan="abort")
    return _run(what, ref_cfg)


def phase_rollback(rng, tmp: str, train_path: str, valid_path: str) -> dict:
    """``on_nan = rollback`` on FMB input (the resume phases' caches), 2
    epochs of 24 steps, a save every epoch, log_every 4, from a seeded npz:
    the plan nan@30:31 poisons the host-side loss of step 30, the log point
    at 32 raises with the cursor (1, 8), the run restores the step-24 save
    into its live tensors and trains batches 8-23 of epoch 1.  Bitwise the
    reference that resumes the same checkpoint at that cursor, within
    TABLE_ATOL of the same rollback on the CPU; the same on the device
    cache at K = 8 (nan@30:33: the call ending at 32) with one graph
    capture; with max_rollbacks = 1 and a second window the run raises."""
    import torch

    from fast_tffm_tpu_torch import training
    from fast_tffm_tpu_torch.config import build_model
    from fast_tffm_tpu_torch.resilience import NonFiniteLossError, clear_faults
    from fast_tffm_tpu_torch.trainer import unpack_state

    name = "rollback"
    train_path, valid_path = _own_files(tmp, "resume", train_path, valid_path)
    base = _b5(binary_cache=True, on_nan="rollback", save_every_epochs=1, epoch_num=2,
               log_every=4)
    model = build_model(base)
    width = model.row_dim
    _, _, init = _seeded_init(rng, tmp, name, base, model, False)
    files = dict(train_files=(train_path,), validation_files=(valid_path,))
    restore_ms = []
    real_restore = training.restore_checkpoint

    def timed_restore(*a, **kw):
        t0 = time.perf_counter()
        out = real_restore(*a, **kw)
        if out.table.is_cuda:
            torch.cuda.synchronize()
        restore_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    training.restore_checkpoint = timed_restore
    out, launches, states = {}, {}, {}
    try:
        for k in (1, 8):
            key = f"k{k}"
            extra = {"device_cache": True, "steps_per_call": 8} if k == 8 else {}
            cfg = _phase_cfg(base, tmp, f"{name}_{key}", "cuda", init, **files, **extra,
                             metrics_path=os.path.join(tmp, f"{name}_{key}.jsonl"))
            keep, stamps = cfg.model_file + ".epoch0", []
            with _captures() as caps:
                def make_hook(cfg=cfg, keep=keep, stamps=stamps, caps=caps, k=k):
                    caps["n"] = 0
                    restore_ms.clear()
                    return _armed(ROLLBACK_PLANS[k], cfg.model_file, keep, TRAIN_BATCHES,
                                  stamps)

                run = _run(f"{name} {key}", cfg, make_hook=make_hook)
            clear_faults()
            line = (f"on_nan = rollback: non-finite loss at step 32; restored {cfg.model_file} "
                    "(step 24), skipping input to epoch 1 batch 8 (rollback 1/2)")
            if line not in run["log"]:
                fail(f"{name} {key}: no rollback line {line!r} in {run['log'][-6:]}")
            recs = [r for r in _records(cfg.metrics_path) if r["kind"] == "anomaly"]
            if [r["event"] for r in recs] != ["nonfinite_loss", "rollback"]:
                fail(f"{name} {key}: anomaly records {recs}")
            note = {f: recs[1][f] for f in ("restored_step", "skip_to_epoch", "skip_to_batch")}
            if note != {"restored_step": 24, "skip_to_epoch": 1, "skip_to_batch": 8}:
                fail(f"{name} {key}: the rollback record is {recs[1]}")
            state = unpack_state(run["state"], model)
            if state.step != 40:
                fail(f"{name} {key}: ended at step {state.step}, not 24 + 16 = 40")
            _expect_steps(f"{name} {key}", run["launches"], 48)  # 32 steps, then 16
            if k == 8 and caps["n"] != 1:
                fail(f"{name} {key}: {caps['n']} graph captures; the rollback must make none")
            ref = _skip_reference(f"{name} {key} reference", cfg, keep, 1, 8, width)
            _expect_steps(f"{name} {key} reference", ref["launches"], 16)
            if not _logical_equal(state, unpack_state(ref["state"], model)):
                fail(f"{name} {key}: the rolled-back run is not bitwise the run that resumes "
                     "the step-24 save at the skip cursor")
            states[key] = state
            launches[f"{name}_{key}"] = run["launches"]
            launches[f"{name}_{key}_reference"] = ref["launches"]
            out[key] = {
                "plan": ROLLBACK_PLANS[k], "restored_step": 24,
                "skip_cursor": {"epoch": 1, "batch_in_epoch": 8}, "final_step": state.step,
                "bitwise_reference": True, "launches": run["launches"],
                "reference_launches": ref["launches"],
                "graph_captures": caps["n"] if k == 8 else None,
                "restore_ms": restore_ms[-1] if restore_ms else None,
                "rollback_wall_ms": _rollback_gap_ms(stamps), "wall_ms": run["wall_ms"],
                "trace_lost_events": run.get("trace_lost_events"),
            }
        # The same rollback on the CPU.
        cpu_cfg = _phase_cfg(base, tmp, f"{name}_k1", "cpu", init, **files)
        cpu_stamps = []
        hook = _armed(ROLLBACK_PLANS[1], cpu_cfg.model_file, cpu_cfg.model_file + ".epoch0",
                      TRAIN_BATCHES, cpu_stamps)
        cpu_state, cpu_s = _train_once(cpu_cfg, "cpu", [], step_hook=hook)
        clear_faults()
        card, cpu = states["k1"], unpack_state(cpu_state, model)
        table_err = float((card.table.cpu() - cpu.table).abs().max())
        accum_err = float((card.table_accum.cpu() - cpu.table_accum).abs().max())
        if cpu.step != 40 or not (table_err <= TABLE_ATOL and accum_err <= TABLE_ATOL):
            fail(f"{name}: the card's rollback run differs from the CPU's by {table_err} "
                 f"and {accum_err} (CPU step {cpu.step})")
        # The budget: one rollback, two windows.
        budget_cfg = _phase_cfg(base, tmp, f"{name}_budget", "cuda", init, **files,
                                max_rollbacks=1)
        _zero_counters()
        hook = _armed("nan@30:31,nan@34:35", budget_cfg.model_file,
                      budget_cfg.model_file + ".epoch0", TRAIN_BATCHES, [])
        try:
            _train_once(budget_cfg, "cuda", [], step_hook=hook)
            fail(f"{name}: max_rollbacks = 1 and two nan windows: the run did not raise")
        except NonFiniteLossError as e:
            raised_at = e.step
        clear_faults()
        launches[f"{name}_budget"] = _wrapper_counts()
        _expect_steps(f"{name} budget", launches[f"{name}_budget"], 32 + 12)
        if raised_at != 36:
            fail(f"{name}: the second window raised at step {raised_at}, not 36")
    finally:
        training.restore_checkpoint = real_restore
    emit({
        "phase": name, "config": CONFIG + ' + {"binary_cache": true, "on_nan": "rollback", '
        '"save_every_epochs": 1, "epoch_num": 2, "log_every": 4}', **out,
        "bitwise_k8_k1": _logical_equal(states["k1"], states["k8"]),
        "cpu": {"max_abs_table_diff": table_err, "max_abs_accum_diff": accum_err,
                "seconds": cpu_s},
        "budget": {"max_rollbacks": 1, "plan": "nan@30:31,nan@34:35", "raised_at": raised_at,
                   "launches": launches[f"{name}_budget"]},
    })
    return launches


def _cli_records(path: str, kind: str) -> list:
    return [r for r in _records(path) if r["kind"] == kind] if os.path.exists(path) else []


def phase_supervised(rng, tmp: str, train_path: str, valid_path: str) -> dict:
    """``cli train --supervised --resume`` from a seeded npz on FMB input (the
    resume phases' caches), 24 steps, a save every 4 (the first boundary a
    full save, then deltas): the plan tears delta 2 (step 12; the writer
    thread has published it before the boundary at 16 starts delta 3),
    injects an IO error into the FMB reader's third read and kills the
    child at step 18 (SIGKILL from its step hook); the supervisor
    quarantines the chain from the torn delta on and relaunches with
    --resume, which restores delta 1 (step 8) and ends bitwise the clean
    cli run of the same config (itself bitwise the in-process run, whose
    launches the wrappers count).  Then kill_publish@2: SIGKILL between delta 1's tmp file and its rename (the
    second publish, step 8); the relaunch restores the chain head, the full
    save at step 4, and ends bitwise.  The crash and restart records (MTTR)
    from the metrics."""
    import shutil

    from fast_tffm_tpu_torch.config import build_model, load_config

    name = "supervised"
    train_path, _ = _own_files(tmp, "resume", train_path, valid_path)
    base = _b5()
    model = build_model(base)
    _, _, init = _seeded_init(rng, tmp, name, base, model, False)

    def ini(tag: str) -> str:
        model_file = os.path.join(tmp, f"{name}_{tag}.ckpt")
        shutil.copy(init, model_file)
        return _write_ini(
            os.path.join(tmp, f"{name}_{tag}.cfg"),
            General={"model_file": model_file},
            Train={"train_files": train_path, "validation_files": "", "binary_cache": "true",
                   "log_every": 4, "metrics_path": model_file + ".jsonl"},
            Checkpoint={"delta_every_steps": 4},
            Resilience={"restart_backoff_s": 0.5},
        )

    ref_cfg = load_config(ini("reference"))
    ref = _run(f"{name} reference", ref_cfg)
    _expect_steps(f"{name} reference", ref["launches"], TRAIN_BATCHES)
    # The clean run and each plan's run at once: each has its own files, and
    # the faults are set by step, read and publish, not by time.
    clean_path = ini("clean")
    clean = _cli_start(["train", clean_path, "--resume"])
    cfg_paths = [ini(f"plan{n}") for n in range(len(SUPERVISED_PLANS))]
    runs = [_cli_start(["train", cfg_path, "--resume", "--supervised", "--fault-plan", plan])
            for cfg_path, plan in zip(cfg_paths, SUPERVISED_PLANS)]
    r, _ = _cli_end(clean)
    if r.returncode != 0:
        fail(f"{name}: the clean cli train exited {r.returncode}: {r.stderr[-2000:]}")
    clean_file = load_config(clean_path).model_file
    _same_files(f"{name} clean cli run", clean_file, ref_cfg.model_file, model.row_dim)
    out = {}
    for n, (plan, cfg_path, started) in enumerate(zip(SUPERVISED_PLANS, cfg_paths, runs)):
        cfg = load_config(cfg_path)
        r, wall_s = _cli_end(started, timeout=600)
        if r.returncode != 0:
            fail(f"{name} {plan}: cli train --supervised exited {r.returncode}: "
                 f"{r.stderr[-2000:]} {r.stdout[-2000:]}")
        crashes = [x for x in _cli_records(cfg.metrics_path, "fault") if x["event"] == "crash"]
        restarts = _cli_records(cfg.metrics_path, "restart")
        if ([(c["signal"], c["exit_code"]) for c in crashes] != [(9, -9)]
                or len(restarts) != 1 or not restarts[0]["mttr_s"]):
            fail(f"{name} {plan}: crash records {crashes}, restart records {restarts}")
        quarantined = sum(int(q) for q in re.findall(r"resilience: quarantined (\d+) delta",
                                                     r.stderr))
        io_retries = [x for x in _cli_records(cfg.metrics_path, "fault")
                      if x["event"] == "io_retry"]
        resumed = re.findall(r"resumed from \S+ at step (\d+)", r.stdout)
        if n == 0 and (quarantined < 1 or not io_retries or resumed[-1:] != ["8"]):
            fail(f"{name} {plan}: quarantined {quarantined}, io retries {io_retries}, "
                 f"resumed at {resumed}")
        if n == 1 and resumed[-1:] != ["4"]:
            fail(f"{name} {plan}: the relaunch restored {resumed}, not the chain head at 4")
        _same_files(f"{name} {plan}", cfg.model_file, clean_file, model.row_dim)
        out[plan] = {
            "crash": {k: crashes[0][k] for k in ("step", "signal", "exit_code")},
            "restart": {k: restarts[0][k] for k in ("attempt", "backoff_s", "mttr_s")},
            "chain_repair_quarantined": quarantined, "io_retry": len(io_retries),
            "resumed_at_step": int(resumed[-1]), "bitwise_clean_run": True,
            "wall_s": wall_s,
        }
    emit({"phase": name, "config": CONFIG + ' + {"binary_cache": true, "delta_every_steps": 4}',
          "runs": out, "reference_launches": ref["launches"]})
    return {f"{name}_reference": ref["launches"]}


def _host_batches(path: str, vocab: int) -> list:
    """The train file's batches, parsed on the host (the follow phase's rows)."""
    from fast_tffm_tpu_torch.data.native import best_parser
    from fast_tffm_tpu_torch.data.pipeline import batch_stream

    return [p for p, _ in batch_stream([path], batch_size=BATCH, vocabulary_size=vocab,
                                       max_nnz=NNZ, parser=best_parser(8))]


def _append(writer, batches, torn: bool = False) -> None:
    import numpy as np

    cat = lambda f: np.concatenate([getattr(p, f) for p in batches])  # noqa: E731
    (writer.append_torn if torn else writer.append)(
        cat("labels"), cat("ids"), cat("vals"), nnz=cat("nnz"))


def _write_fms(path: str, batches, vocab: int) -> str:
    from fast_tffm_tpu_torch.data.stream import StreamWriter

    with StreamWriter(path, width=NNZ, vocabulary_size=vocab) as w:
        _append(w, batches)
    return path


def _stream_writer(path: str, batches, vocab: int, plan: str, started, first: int,
                   burst: int = 2, gap_s: float = 0.05):
    """A thread that appends ``batches`` to the FMS file ``path``: the first
    ``first`` (one call's worth), then, once ``started`` is set (the
    trainer's first call: the run consumes the stream live, not a
    backlog), bursts of ``burst`` batches every ``gap_s`` seconds; it runs the plan's stream faults itself:
    ``append_torn@K`` leaves the Kth append's last record half written
    until the next append, ``stream_stall@N`` pauses N seconds after half
    the bursts.  Returns (thread, errors, stall seconds)."""
    import threading

    from fast_tffm_tpu_torch.data.stream import StreamWriter
    from fast_tffm_tpu_torch.resilience import FaultPlan

    events = FaultPlan.parse(plan).stream_events()
    torn = {e["at"] for e in events if e["kind"] == "append_torn"}
    stall = sum(e["at"] for e in events if e["kind"] == "stream_stall")
    w = StreamWriter(path, width=NNZ, vocabulary_size=vocab)
    errors = []

    def run():
        try:
            groups = [batches[:first]] + [batches[i:i + burst]
                                          for i in range(first, len(batches), burst)]
            for n, group in enumerate(groups, 1):
                _append(w, group, torn=n in torn)
                if n == 1 and not started.wait(300):
                    raise TimeoutError("the trainer made no first call in 300 s")
                time.sleep(gap_s)
                if n == len(groups) // 2 and stall:
                    time.sleep(stall)
            w.close()
        except Exception as e:  # surfaced by the phase after the join
            errors.append(e)

    return threading.Thread(target=run, name="fms-writer", daemon=True), errors, stall


def phase_follow(tmp: str, train_path: str, valid_path: str) -> dict:
    """``[Online] follow`` at full width: the 24 x 16384 train rows as an FMS
    stream (11 slots a row), followed with max_batches 24, poll 0.02 s and
    an idle timeout of 5 s, at K = 1 (eager) and K = 8 (CUDA graphs): each
    over the file written whole before the start, and over a file a writer
    thread appends in bursts of 2 batches every 0.05 s while it trains,
    with a 1 s stall halfway and a torn third append (FOLLOW_PLAN).  Each
    live run bitwise its whole-file run, every run within TABLE_ATOL of
    the CPU's whole-file run, the stall seen in the live runs' kind=input
    records, ex/s and the card's idle share of each run (traced).  Then
    cli train on a half-written stream (12 batches, no idle timeout) gets
    SIGTERM while it polls: it saves the cursor and exits 0; the rest lands
    and cli train --resume ends bitwise the whole-file K = 1 run."""
    import shutil
    import threading

    from fast_tffm_tpu_torch.checkpoint import read_input_cursor
    from fast_tffm_tpu_torch.config import build_model
    from fast_tffm_tpu_torch.trainer import unpack_state

    name = "follow"
    base = _b5(online_follow=True, online_max_batches=TRAIN_BATCHES, online_idle_timeout_s=5.0,
               online_poll_s=0.02, log_every=8)
    model = build_model(base)
    vocab = base.vocabulary_size
    batches = _host_batches(train_path, vocab)
    init = os.path.join(tmp, f"{name}.init.ckpt")
    shutil.copy(os.path.join(tmp, "train.init.ckpt"), init)  # the train phase's seeded npz
    whole = _write_fms(os.path.join(tmp, f"{name}_whole.fms"), batches, vocab)
    runs, launches, out = {}, {}, {}
    for k in (1, 8):
        for mode in ("whole", "live"):
            key = f"{mode}_k{k}"
            fms = whole if mode == "whole" else os.path.join(tmp, f"{name}_{key}.fms")
            cfg = _phase_cfg(base, tmp, f"{name}_{key}", "cuda", init, train_files=(fms,),
                             validation_files=(valid_path,), steps_per_call=k,
                             metrics_path=os.path.join(tmp, f"{name}_{key}.jsonl"))
            box = {}

            def make_hook(fms=fms, box=box, mode=mode):
                if mode != "live":
                    return None
                if os.path.exists(fms):
                    os.remove(fms)
                started = threading.Event()
                box["thread"], box["errors"], box["stall_s"] = _stream_writer(
                    fms, batches, vocab, FOLLOW_PLAN, started, first=k)
                box["thread"].start()
                return lambda step: started.set()

            run = _run(f"{name} {key}", cfg, make_hook=make_hook, trace=True)
            if mode == "live":
                box["thread"].join(60)
                if box["thread"].is_alive() or box["errors"]:
                    fail(f"{name} {key}: the stream writer {box['errors'] or 'hung'}")
            state = unpack_state(run["state"], model)
            _expect_steps(f"{name} {key}", run["launches"], TRAIN_BATCHES)
            cursor = read_input_cursor(cfg.model_file)
            if state.step != TRAIN_BATCHES or not (cursor["follow"] is True
                                                   and cursor["batch_in_epoch"] == TRAIN_BATCHES):
                fail(f"{name} {key}: step {state.step}, cursor {cursor}")
            inputs = [r for r in _records(cfg.metrics_path) if r["kind"] == "input"]
            produce_ms = sum(r["parse_ms"] * r["input_items"] for r in inputs)
            runs[key] = state
            launches[f"{name}_{key}"] = run["launches"]
            out[key] = {
                "launches": run["launches"], "wall_ms": run["wall_ms"],
                "examples_per_s_run": TRAIN_BATCHES * BATCH / (run["wall_ms"] / 1e3),
                "examples_per_s_logged": _logged(run["log"], "examples/sec"),
                "device_busy_ms": run["device_busy_ms"],
                "device_idle_share": run["device_idle_share"],
                "input_produce_ms": produce_ms, "input_records": len(inputs),
                "trace_lost_events": run.get("trace_lost_events"),
            }
            if mode == "live":
                stall_ms = 1e3 * box["stall_s"]
                if produce_ms < 0.8 * stall_ms:
                    fail(f"{name} {key}: the input records hold {produce_ms} ms of production "
                         f"for a {stall_ms} ms stall of the writer")
                if not _logical_equal(state, runs[f"whole_k{k}"]):
                    fail(f"{name} {key}: the live stream's run is not bitwise the whole file's")
                out[key]["bitwise_whole"] = True
    cpu_cfg = _phase_cfg(base, tmp, f"{name}_whole_k1", "cpu", init, train_files=(whole,),
                         validation_files=(valid_path,))
    cpu_state, cpu_s = _train_once(cpu_cfg, "cpu", [])
    cpu = unpack_state(cpu_state, model)
    for key, state in runs.items():
        t = float((state.table.cpu() - cpu.table).abs().max())
        a = float((state.table_accum.cpu() - cpu.table_accum).abs().max())
        if not (t <= TABLE_ATOL and a <= TABLE_ATOL):
            fail(f"{name} {key}: the card's run differs from the CPU's by {t} and {a}")
        out[key].update(max_abs_table_diff=t, max_abs_accum_diff=a)
    out["bitwise_k8_k1"] = _logical_equal(runs["whole_k1"], runs["whole_k8"])
    out["cli_sigterm"] = _follow_cli_sigterm(tmp, batches, vocab, init, runs["whole_k1"])
    emit({"phase": name, "config": CONFIG + " + " + json.dumps(
        {"follow": True, "max_batches": TRAIN_BATCHES, "idle_timeout_s": 5.0, "poll_s": 0.02}),
        "writer_plan": FOLLOW_PLAN, "rows": TRAIN_BATCHES * BATCH, "cpu_seconds": cpu_s, **out})
    return launches


def _follow_cli_sigterm(tmp: str, batches, vocab: int, init: str, reference) -> dict:
    """cli train on a stream of 12 batches with no idle timeout, SIGTERM
    after its step-12 log line while the reader polls the idle file: exit
    0, the stop logged, the cursor at batch 12; the other 12 land and cli
    train --resume ends bitwise ``reference``."""
    import shutil

    from fast_tffm_tpu_torch.checkpoint import read_input_cursor
    from fast_tffm_tpu_torch.data.stream import StreamWriter

    fms = _write_fms(os.path.join(tmp, "follow_cli.fms"), batches[:12], vocab)
    model_file = os.path.join(tmp, "follow_cli.ckpt")
    shutil.copy(init, model_file)
    ini = _write_ini(
        os.path.join(tmp, "follow_cli.cfg"),
        General={"model_file": model_file},
        Train={"train_files": fms, "validation_files": "", "log_every": 4},
        Online={"follow": "true", "poll_s": 0.05, "max_batches": TRAIN_BATCHES},
    )
    proc = subprocess.Popen([sys.executable, "-m", "fast_tffm_tpu_torch.cli", "train", ini,
                             "--resume"], cwd=HERE, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    lines, t_signal = [], None
    try:
        for line in proc.stderr:
            lines.append(line.rstrip("\n"))
            if t_signal is None and line.startswith("step 12 "):
                time.sleep(1.0)  # the reader turns idle and polls
                t_signal = time.perf_counter()
                proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stop_s = None if t_signal is None else time.perf_counter() - t_signal
    cursor = read_input_cursor(model_file)
    if (rc != 0 or "stopped on signal at step 12" not in "\n".join(lines)
            or cursor.get("batch_in_epoch") != 12 or cursor.get("follow") is not True):
        fail(f"follow: cli train sent SIGTERM on an idle stream exited {rc}, cursor {cursor}: "
             f"{lines[-5:]}")
    with StreamWriter(fms, width=NNZ, vocabulary_size=vocab) as w:
        _append(w, batches[12:])
    r = _cli(["train", ini, "--resume"])
    if r.returncode != 0 or "resuming input at epoch 0, batch 12" not in r.stderr:
        fail(f"follow: cli train --resume after the stop exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    if not _logical_equal(_restored(model_file, reference.table.shape[1]), reference):
        fail("follow: the stopped and resumed cli run is not bitwise the whole-file run")
    return {"exit_code": rc, "stop_after_signal_s": stop_s, "cursor_batch": 12,
            "bitwise_whole_k1": True}


def phase_accum_restart(rng, tmp: str, train_path: str, valid_path: str) -> dict:
    """``accum_restart_steps`` = 16 on the device cache (the resume phases'
    FMB caches), 24 steps from a seeded npz, at K = 1 (eager) and K = 8
    (CUDA graphs, traced): one reset after step 16 in both (the K = 8
    call that ends there), every accumulator equal to the init value right
    after it (checked on the card), the two runs bitwise equal; the reset's
    time (CUDA events) and each run's step time."""
    import dataclasses

    import torch

    from fast_tffm_tpu_torch import training
    from fast_tffm_tpu_torch.config import build_model
    from fast_tffm_tpu_torch.trainer import unpack_state

    name = "accum_restart"
    train_path, valid_path = _own_files(tmp, "resume", train_path, valid_path)
    base = _b5(binary_cache=True, device_cache=True,
               online_accum_restart_steps=ACCUM_RESTART_STEPS, log_every=8)
    model = build_model(base)
    _, _, init = _seeded_init(rng, tmp, name, base, model, False)
    resets = []
    real = training.make_accum_restart

    def checked(value):
        reset = real(value)

        def run(state):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state = reset(state)
            end.record()
            end.synchronize()
            at_init = bool((state.table_accum == value).all()) and all(
                bool((a == value).all()) for a in state.dense_accum)
            resets.append({"step": state.step, "at_init": at_init,
                           "ms": start.elapsed_time(end)})
            return state

        return run

    training.make_accum_restart = checked
    out, states, launches = {}, {}, {}
    try:
        for k in (1, 8):
            key = f"k{k}"
            cfg = _phase_cfg(base, tmp, f"{name}_{key}", "cuda", init, steps_per_call=k,
                             train_files=(train_path,), validation_files=(valid_path,))
            hook, p50 = _step_clock()

            def make_hook(hook=hook):
                resets.clear()
                return hook

            run = _run(f"{name} {key}", cfg, make_hook=make_hook)
            _expect_steps(f"{name} {key}", run["launches"], TRAIN_BATCHES)
            if [(r["step"], r["at_init"]) for r in resets] != [(ACCUM_RESTART_STEPS, True)]:
                fail(f"{name} {key}: resets {resets}, one at step {ACCUM_RESTART_STEPS} to the "
                     "init value expected")
            states[key] = unpack_state(run["state"], model)
            launches[f"{name}_{key}"] = run["launches"]
            rates = sorted(_logged(run["log"], "examples/sec"))
            out[key] = {"launches": run["launches"], "resets": list(resets),
                        "call_ms_p50": p50(), "step_ms_p50": None if p50() is None
                        else p50() / k,
                        "step_ms_logged_median": 1e3 * BATCH / rates[len(rates) // 2]
                        if rates else None,
                        "wall_ms": run["wall_ms"],
                        "trace_lost_events": run.get("trace_lost_events")}
    finally:
        training.make_accum_restart = real
    if not _logical_equal(states["k1"], states["k8"]):
        fail(f"{name}: the K = 8 run is not bitwise the K = 1 run")
    if bool((states["k1"].table_accum == base.init_accumulator_value).all()):
        fail(f"{name}: the accumulators end at the init value: steps after the reset ran none")
    emit({"phase": name, "config": CONFIG + " + " + json.dumps(
        {"device_cache": True, "binary_cache": True,
         "accum_restart_steps": ACCUM_RESTART_STEPS}), **out, "bitwise_k8_k1": True})
    return launches


# -- slice 11: the packed wire and the tiered parameter store --------------

TIERED_HOT_ROWS = 262144  # the tiered phase's hot tier: a quarter of 2^20
TIERED_BIG_VOCAB = 2**31 - 1  # the port's largest vocabulary (config.py)
TIERED_BIG_HOT = 1 << 20
TIERED_BIG_BATCHES = 8


def _timed_run(what: str, cfg, *, resume: bool = True, abort_at: int | None = None,
               trace: bool = True) -> dict:
    """``_run`` with the loop's step clock as its step hook (``abort_at``:
    the run is ended there by ``_Abort``, no final save): adds the step p50,
    the examples per second over the run's wall time and per log window."""
    box = {}

    def make_hook():
        clock, p50 = _step_clock()
        box["p50"] = p50
        abort = _abort_at(abort_at) if abort_at else None

        def hook(step):
            clock(step)
            if abort is not None:
                abort(step)

        return hook

    out = _run(what, cfg, make_hook=make_hook, trace=trace, resume=resume,
               expect_abort=abort_at is not None)
    steps = out["launches"]["anova_bwd"]
    out["speed"] = {
        "steps": steps,
        # the gaps between calls, per step (a K-step call's over K)
        "step_ms_p50": (lambda p: p / cfg.steps_per_call if p is not None else None)(
            box["p50"]()),
        "examples_per_s_run": steps * cfg.batch_size / (out["wall_ms"] / 1e3),
        "examples_per_s_logged": _logged(out["log"], "examples/sec"),
        "device_idle_share": out.get("device_idle_share"),
        "wall_ms": out["wall_ms"],
    }
    return out


def _input_records(path: str) -> list:
    return [r for r in _records(path) if r["kind"] == "input"]


def _tiering(what: str, path: str) -> dict:
    """A tiered run's kind=tiering records, summed or averaged over the run."""
    recs = [r for r in _records(path) if r["kind"] == "tiering"]
    if not recs:
        fail(f"{what}: no kind=tiering record in {path}")
    miss = sum(r["miss_rows"] for r in recs)
    steps = sum(r["miss_rows"] / r["miss_rows_per_step"] for r in recs
                if r["miss_rows_per_step"])
    return {
        "records": len(recs),
        "hit_rate": [r["hit_rate"] for r in recs],
        "miss_rows": miss,
        "miss_rows_per_step": miss / steps if steps else None,
        "wire_bytes_per_step": [r["wire_bytes_per_step"] for r in recs],
        "resolve_ms": sum(r["resolve_ms"] for r in recs),
        "writeback_ms": sum(r["writeback_ms"] for r in recs),
        "writeback_rows": sum(r["writeback_rows"] for r in recs),
        "apply_ms": sum(r["apply_ms"] for r in recs),
        "restages": sum(r["restages"] for r in recs),
        "pending_rows_max": max(r["pending_rows"] for r in recs),
    }


def _tiered_logical(model_file: str, vocab: int):
    """The full logical (table, accumulator) of a finished tiered run: the
    cold store, the npz's pending rows over it, its hot tier over both."""
    import numpy as np

    from fast_tffm_tpu_torch.paramstore import ColdStore

    with np.load(model_file) as z:
        store = ColdStore.open(model_file + ".store")
        t, a = store.read_rows(np.arange(vocab))
        ci = np.asarray(z["tier_cold_idx"], np.int64)
        t[ci], a[ci] = z["tier_cold_rows"], z["tier_cold_accum"]
        hi = np.asarray(z["tier_hot_ids"], np.int64)
        t[hi], a[hi] = z["table"], z["table_accum"]
    return t, a


def _same_logical(what: str, got, want) -> None:
    import numpy as np

    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
        diff = float(np.abs(got[0] - want[0]).max())
        fail(f"{what}: the logical table or accumulator differs (max abs table diff {diff})")


def _state_logical(state):
    return state.table.cpu().numpy(), state.table_accum.cpu().numpy()


def _run_launches(what: str, out: dict) -> dict:
    """A run's step launches with its wrappers' counts beside them (equal
    for an eager run; a graphed run's replays are its trace's)."""
    return {"launches": out["launches"], "wrappers": out["wrappers"],
            "trace_attempts": out.get("trace_attempts"),
            "trace_lost_events": out.get("trace_lost_events")}


def phase_wire(rng, tmp: str, train_path: str) -> dict:
    """FMB input (binary_cache) at K = 1 and K = 8: ``wire_format = packed``
    against ``arrays``, from one seeded npz, 24 steps each, traced: losses
    and final tables bitwise; the H2D bytes per batch from kind=input: at
    K = 8 the wire spec's (computed beforehand from the FMB flags; one
    pinned H2D per call, unpacked on the card on a side stream), at K = 1
    none measured (the eager loop converts under either setting); ex/s and
    the card's idle share."""
    import dataclasses

    from fast_tffm_tpu_torch.config import build_model
    from fast_tffm_tpu_torch.data.binary import ensure_fmb_cache, fmb_wire_flags
    from fast_tffm_tpu_torch.data.wire import arrays_nbytes, make_spec

    base = _b5(validation_files=())
    model = build_model(base)
    _, _, init = _seeded_init(rng, tmp, "wire", base, model, False)
    (src,) = _own_files(tmp, "wire", train_path)
    fmb = ensure_fmb_cache([src], vocabulary_size=base.vocabulary_size, max_nnz=NNZ,
                           log=log_stderr)
    ones, _ = fmb_wire_flags(fmb)
    spec = make_spec(base.vocabulary_size, NNZ, with_vals=not ones, with_fields=False,
                     with_weights=False)
    want = {"packed": spec.batch_nbytes(BATCH), "arrays": arrays_nbytes(BATCH, NNZ, False)}
    rec, observed = {"phase": "wire", "vals_all_ones": ones, "spec": spec._asdict(),
                     "bytes_per_batch_expected": want}, {}
    for k in (1, 8):
        outs = {}
        for fmt in ("packed", "arrays"):
            name = f"wire_{fmt}_k{k}"
            # K = 8: 2 epochs, so the step clock sees 6 calls.
            cfg = _phase_cfg(base, tmp, name, "cuda", init, train_files=(src,),
                             binary_cache=True, steps_per_call=k, wire_format=fmt,
                             log_every=8, epoch_num=1 if k == 1 else 2,
                             metrics_path=os.path.join(tmp, name + ".jsonl"))
            outs[fmt] = out = _timed_run(name, cfg)
            _expect_steps(name, out["wrappers"] if k == 1 else out["launches"],
                          cfg.epoch_num * TRAIN_BATCHES)
            observed[name] = out["launches"]
            inputs = _input_records(cfg.metrics_path)
            shipped = {r["wire_bytes_per_step"] for r in inputs}
            # The prefetch thread's time per item: producing the batches and
            # (packed) the pack + H2D + unpack dispatch; the queue's depth.
            rec[name] = {**out["speed"], **_run_launches(name, out),
                         "wire_bytes_per_step": sorted(shipped, key=str),
                         **{key: [r[key] for r in inputs]
                            for key in ("parse_ms", "h2d_ms", "prefetch_queue_depth")}}
        p, a = outs["packed"], outs["arrays"]
        if _logged(p["log"], "loss") != _logged(a["log"], "loss") or not _logical_equal(
                p["state"], a["state"]):
            fail(f"wire k{k}: the packed run differs from the arrays run")
        # K = 1 converts in the loop (no bytes measured); K = 8 ships the spec's.
        expect = [want["packed"] if k > 1 else None]
        if rec[f"wire_packed_k{k}"]["wire_bytes_per_step"] != expect:
            fail(f"wire k{k}: shipped {rec[f'wire_packed_k{k}']['wire_bytes_per_step']} bytes "
                 f"a step, expected {expect}")
        rec[f"bitwise_k{k}"] = True
    emit(rec)
    return observed


def phase_tiered(tmp: str, train_path: str, valid_path: str) -> dict:
    """baseline5 with ``[ParamStore]`` (hot_rows 262,144 of 2^20 by the
    sample policy over 8 batches, materialize auto: the store holds
    ``init_state``'s host draw), every run against a resident run from an
    npz of that draw, traced, one epoch (24 steps) each: K = 1 streamed
    text (a delta every 8 steps, a full save at the epoch end; validation)
    and K = 8 FMB (2 epochs: 6 calls), losses, AUCs and the logical table and accumulator
    (store + hot tier) bitwise; the row accumulator; the K = 1 run on the
    CPU (tables within TABLE_ATOL); a run aborted at step 20 and resumed
    from its chain head (base 8 + delta 16), and a ``cli train --fault-plan
    kill_writeback@1`` child (SIGKILL inside the first store apply, at
    step 8) and its resume, each bitwise the uninterrupted run.  Per run:
    ex/s, step p50, idle share and the kind=tiering counters."""
    import dataclasses

    import numpy as np
    import torch

    from fast_tffm_tpu_torch.checkpoint import save_checkpoint
    from fast_tffm_tpu_torch.config import build_model
    from fast_tffm_tpu_torch.trainer import init_state

    t_phase = time.perf_counter()
    base = _b5(log_every=8, train_files=(train_path,), validation_files=(valid_path,))
    model = build_model(base)
    vocab = base.vocabulary_size
    tier = dict(paramstore=True, paramstore_hot_rows=TIERED_HOT_ROWS,
                paramstore_residency="sample", paramstore_sample_batches=8,
                paramstore_materialize="auto", delta_every_steps=DELTA_EVERY)
    inits = {}
    for acc in ("element", "row"):
        inits[acc] = os.path.join(tmp, f"tiered.init.{acc}.ckpt")
        save_checkpoint(inits[acc], init_state(model, torch.Generator().manual_seed(0),
                                               base.init_accumulator_value, acc))
    (fmb_src,) = _own_files(tmp, "tiered_fmb", train_path)
    rec, observed, runs = {"phase": "tiered", "hot_rows": TIERED_HOT_ROWS}, {}, {}

    def cfg_of(name, device="cuda", resident=False, **kw):
        metrics = os.path.join(tmp, f"{name}.{device}.jsonl")
        if resident:
            return _phase_cfg(base, tmp, name, device, inits[kw.pop("acc", "element")],
                              metrics_path=metrics, **kw)
        return dataclasses.replace(base, model_file=os.path.join(tmp, f"{name}.{device}.ckpt"),
                                   metrics_path=metrics, **tier, **kw).validate()

    def card(name, cfg, **kw):
        runs[name] = out = _timed_run(name, cfg, **kw)
        observed[name] = out["launches"]
        rec[name] = {**out["speed"], **_run_launches(name, out)}
        if cfg.paramstore:
            rec[name]["tiering"] = _tiering(name, cfg.metrics_path)
        return out

    def pair(label, res_name, tier_name, check_auc=True):
        r, t = runs[res_name], runs[tier_name]
        if _logged(r["log"], "loss") != _logged(t["log"], "loss") or not _logged(r["log"], "loss"):
            fail(f"tiered {label}: the losses differ from the resident run's")
        auc = [[x for x in o["log"] if "validation auc" in x] for o in (r, t)]
        if check_auc and (auc[0] != auc[1] or not auc[0]):
            fail(f"tiered {label}: validation {auc[1]} against the resident run's {auc[0]}")
        _same_logical(f"tiered {label}", _tiered_logical(t["cfg"].model_file, vocab),
                      _state_logical(r["state"]))
        rec[f"bitwise_resident_{label}"] = True

    card("tiered_res_k1", cfg_of("tiered_res_k1", resident=True))
    k1 = card("tiered_k1", cfg_of("tiered_k1"), resume=False)
    pair("k1", "tiered_res_k1", "tiered_k1")
    _expect_steps("tiered_k1", k1["wrappers"], TRAIN_BATCHES)
    whole = _tiered_logical(k1["cfg"].model_file, vocab)
    # The same run on the CPU.
    cpu_cfg, lines = cfg_of("tiered_k1", device="cpu"), []
    t0 = time.perf_counter()
    _train_once(cpu_cfg, "cpu", lines, resume=False)
    cpu = _tiered_logical(cpu_cfg.model_file, vocab)
    diffs = [float(np.abs(c - g).max()) for c, g in zip(cpu, whole)]
    rec["cpu_k1"] = {"seconds": time.perf_counter() - t0, "max_abs_table_diff": diffs[0],
                     "max_abs_accum_diff": diffs[1],
                     "losses_cuda": _logged(k1["log"], "loss")[-3:],
                     "losses_cpu": _logged(lines, "loss")[-3:]}
    if max(diffs) > TABLE_ATOL:
        fail(f"tiered: the card run differs from the CPU run by {diffs}")
    # Aborted after the delta at 16 (base 8), resumed from the chain head.
    cut = cfg_of("tiered_cut")
    card("tiered_cut", cut, resume=False, abort_at=20)
    card("tiered_cut_resumed", cut)
    _same_logical("tiered resume", _tiered_logical(cut.model_file, vocab), whole)
    rec["bitwise_resumed"] = True
    # kill_writeback@1: the child dies inside the first boundary's store apply.
    kill = cfg_of("tiered_kill")
    ini = _write_ini(
        os.path.join(tmp, "tiered_kill.cfg"),
        General={"model_file": kill.model_file},
        Train={"train_files": train_path, "validation_files": valid_path, "log_every": 8},
        Checkpoint={"delta_every_steps": DELTA_EVERY},
        ParamStore={"enabled": "true", "hot_rows": TIERED_HOT_ROWS, "residency": "sample",
                    "sample_batches": 8, "materialize": "auto"},
    )
    t0 = time.perf_counter()
    child = _cli(["train", ini, "--fault-plan", "kill_writeback@1"])
    if child.returncode != -signal.SIGKILL:
        fail(f"tiered: the kill_writeback@1 child exited {child.returncode}: "
             f"{child.stderr[-2000:]}")
    rec["kill_child"] = {"returncode": child.returncode, "seconds": time.perf_counter() - t0,
                         "log_tail": child.stderr.strip().splitlines()[-2:]}
    card("tiered_kill_resumed", kill)
    _same_logical("tiered kill_writeback", _tiered_logical(kill.model_file, vocab), whole)
    rec["bitwise_kill_writeback"] = True
    # K = 8 on FMB input: one CUDA graph over the compact table.
    fmb = dict(train_files=(fmb_src,), binary_cache=True, steps_per_call=8, epoch_num=2)
    card("tiered_res_k8", cfg_of("tiered_res_k8", resident=True, **fmb))
    card("tiered_k8", cfg_of("tiered_k8", **fmb), resume=False)
    pair("k8", "tiered_res_k8", "tiered_k8")
    # The row accumulator, one epoch without validation.
    row = dict(adagrad_accumulator="row", validation_files=())
    card("tiered_res_row", cfg_of("tiered_res_row", resident=True, acc="row", **row))
    card("tiered_row", cfg_of("tiered_row", **row), resume=False)
    pair("row", "tiered_res_row", "tiered_row", check_auc=False)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return observed


def _store_pages(ids, row_dim: int) -> int:
    """Bytes of the 4 KiB pages that rows ``ids`` of a store span: in the
    table and the element accumulator (``row_dim`` float32 each) and in
    the written bitmap (a bit a row)."""
    import numpy as np

    row = 4 * row_dim
    spans = np.unique(np.concatenate([ids * row // 4096, ((ids + 1) * row - 1) // 4096]))
    return 4096 * (2 * int(spans.size) + int(np.unique((ids >> 3) // 4096).size))


def _written_ids(path: str, chunk: int = 64 << 20):
    """The row ids a store's written bitmap marks, read a chunk at a time."""
    import numpy as np

    out, off = [], 0
    with open(path, "rb") as f:
        while buf := f.read(chunk):
            b = np.frombuffer(buf, np.uint8)
            nz = np.flatnonzero(b)
            bits = np.unpackbits(b[nz, None], axis=1, bitorder="little")
            r, c = np.nonzero(bits)
            out.append((off + nz[r]) * 8 + c)
            off += b.size
    return np.sort(np.concatenate(out)).astype(np.int64) if out else np.zeros(0, np.int64)


def phase_tiered_big(tmp: str) -> dict:
    """baseline5's widths at vocabulary 2^31 - 1, whose resident table and
    element accumulator would need 154.6 GB: a lazy store (materialize auto
    goes lazy past 2^21 rows), hot_rows 2^20 by the sample policy, 8 x
    16,384 rows of gen_synthetic over that vocabulary, one epoch with the
    final save, then a resume at that save.  The disk the store can take
    (the 4 KiB pages the data's ids span in the table, accumulator and
    bitmap files) is reckoned before the run.  Prints the losses, peak
    device memory, the store files' apparent size against the pages of the
    rows its bitmap marks written (gated: at most the reckoning, a tenth
    of the apparent size at most) and the bytes the filesystem used during
    the run (a witness; st_blocks as it reports them), the tiering
    counters, ex/s, and the rows the store holds after the save."""
    import shutil

    import numpy as np
    import torch

    from fast_tffm_tpu_torch.data.native import best_parser
    from fast_tffm_tpu_torch.data.pipeline import batch_stream
    from fast_tffm_tpu_torch.paramstore import ColdStore

    t_phase = time.perf_counter()
    data = os.path.join(tmp, "tiered_big.train.libsvm")
    _generate([(data, TIERED_BIG_BATCHES * BATCH,
                ["--fields", str(NNZ), "--seed", "11", "--vocab", str(TIERED_BIG_VOCAB)])])
    ids = np.concatenate([p.ids.reshape(-1) for p, _ in batch_stream(
        [data], batch_size=BATCH, vocabulary_size=TIERED_BIG_VOCAB, max_nnz=NNZ,
        parser=best_parser(8))])
    uniq = np.unique(ids).astype(np.int64)
    unique = int(uniq.size)
    # The rows the saves apply to the store are among the data's ids: the
    # 4 KiB pages those span in the table, accumulator and bitmap files
    # bound the disk the store can take.
    need = _store_pages(uniq, 1 + 8)  # baseline5's rows: bias + factor_num 8
    free = shutil.disk_usage(tmp).free
    rec = {"phase": "tiered_big", "vocabulary_size": TIERED_BIG_VOCAB,
           "resident_bytes_needed": TIERED_BIG_VOCAB * (1 + 8) * 4 * 2,
           "unique_ids": unique, "disk_needed_bytes": need, "disk_free_bytes": free}
    if need * 2 > free:
        fail(f"tiered_big: the store would write ~{need} bytes of pages; {free} free")
    cfg = _b5(vocabulary_size=TIERED_BIG_VOCAB, train_files=(data,), validation_files=(),
              model_file=os.path.join(tmp, "tiered_big.ckpt"), log_every=2,
              save_every_epochs=0,  # one save, the final one: it carries every pending row
              metrics_path=os.path.join(tmp, "tiered_big.jsonl"), paramstore=True,
              paramstore_hot_rows=TIERED_BIG_HOT, paramstore_residency="sample",
              paramstore_materialize="auto")
    used0 = shutil.disk_usage(tmp).used
    torch.cuda.reset_peak_memory_stats()
    out = _timed_run("tiered_big", cfg, resume=False, trace=False)
    torch.cuda.synchronize()
    losses = _logged(out["log"], "loss")
    if len(losses) != TIERED_BIG_BATCHES // 2 or not all(np.isfinite(losses)):
        fail(f"tiered_big: losses {losses}")
    if not any("lazy cold store" in x for x in out["log"]):
        fail("tiered_big: the store was not lazy")
    _expect_steps("tiered_big", out["wrappers"], TIERED_BIG_BATCHES)
    store_dir = cfg.model_file + ".store"
    used = shutil.disk_usage(tmp).used - used0
    with np.load(cfg.model_file) as z:
        ci = np.asarray(z["tier_cold_idx"], np.int64)
        cold = (np.asarray(z["tier_cold_rows"]), np.asarray(z["tier_cold_accum"]))
    store = ColdStore.open(store_dir)
    got = store.read_rows(ci)
    if not (np.array_equal(got[0], cold[0]) and np.array_equal(got[1], cold[1])):
        fail("tiered_big: the store does not hold the rows the final save applied")
    # Sparse, by the store's own count: its bitmap marks exactly the rows
    # the one save applied (``ci``, read back above), and the 4 KiB pages
    # those rows span in each file are all a sparse file allocates.  That
    # must be within the reckoning made from the data and far under the
    # files' apparent size.
    # The filesystem's used bytes over the run are a second witness, kept
    # but not gated: other writers on the host move them.  A 9p mount (the
    # card host's) reports every block of a file as allocated, holes
    # included, so st_blocks is recorded as the filesystem reports it.
    marked = _written_ids(os.path.join(store_dir, "written.dat"))
    if not np.array_equal(marked, np.unique(ci)):
        fail(f"tiered_big: the store marks {marked.size} rows written, the save applied "
             f"{np.unique(ci).size}")
    files = {name: {"apparent_bytes": os.stat(os.path.join(store_dir, name)).st_size,
                    "st_blocks_bytes": os.stat(os.path.join(store_dir, name)).st_blocks * 512}
             for name in ("table.dat", "accum.dat", "written.dat")}
    apparent = sum(f["apparent_bytes"] for f in files.values())
    written = _store_pages(marked, store.row_dim)
    files["written_page_bytes"] = written
    files["filesystem_used_bytes_during_run"] = used
    files["filesystem_witness_sparse"] = used * 10 <= apparent
    files["st_blocks_note"] = "a 9p mount reports holes as allocated"
    if written > need or written * 10 > apparent:
        fail(f"tiered_big: the store is not sparse: {files} (reckoned {need})")
    rec.update({
        "losses": losses, "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "store_files": files, "applied_rows_read_back": int(ci.size),
        "tiering": _tiering("tiered_big", cfg.metrics_path), **out["speed"],
        **_run_launches("tiered_big", out),
    })
    # The resume restores both tiers and trains on for 5 steps (every missed
    # row now a written one, read from the store's files).
    resumed = _timed_run("tiered_big_resumed", cfg, trace=False,
                         abort_at=TIERED_BIG_BATCHES + 5)
    r_losses = _logged(resumed["log"], "loss")
    if (not any("resumed tiered run" in x for x in resumed["log"])
            or len(r_losses) != 2 or not all(np.isfinite(r_losses))):
        fail(f"tiered_big: the resume at the save did not train on: {resumed['log'][-3:]}")
    rec["resumed"] = {"losses": r_losses, **resumed["speed"]}
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return {"tiered_big": out["launches"], "tiered_big_resumed": resumed["launches"]}


# --- slice 12: dist_train / dist_predict over the mesh of ranks -------------

B2_CONFIG = os.path.join("configs", "baseline2_fm_sharded.cfg")
B2_VOCAB, B2_FIELDS = 1 << 24, 39
B2_TRAIN_BATCHES, B2_VALID_ROWS = 24, 32768


def _start_b2_data(tmp: str):
    """baseline2's data, started in the background at the run's start (it
    is read only by dist_b2): 24 x 16,384 rows of gen_synthetic --fields 39
    --vocab 16777216 --seed 3, and 32,768 validation rows (--seed 4)."""
    gen = GEN_SYNTHETIC
    out = {}
    for part, rows, seed in (("train", B2_TRAIN_BATCHES * BATCH, 3),
                             ("valid", B2_VALID_ROWS, 4)):
        path = os.path.join(tmp, f"baseline2.{part}.libsvm")
        cmd = [sys.executable, gen, "--rows", str(rows), "--fields", str(B2_FIELDS),
               "--vocab", str(B2_VOCAB), "--seed", str(seed), "--out", path]
        out[part] = (path, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                            stderr=subprocess.PIPE, text=True),
                     time.perf_counter())
    return out


def _wait_b2_data(jobs) -> dict:
    paths = {}
    for part, (path, proc, t0) in jobs.items():
        try:
            _, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"gen_synthetic ({path}) did not finish in 300 s")
        if proc.returncode != 0:
            fail(f"gen_synthetic ({path}) failed with exit {proc.returncode}: {err}")
        paths[part] = path
    return paths


@contextlib.contextmanager
def _clocked(name: str, then=None):
    """``training.<name>`` wrapped for the time of the block so that its
    callers (the CLI) run it with the loop's step clock as the step hook
    (and ``then(step)`` after it); yields the clock's p50."""
    from fast_tffm_tpu_torch import training

    real = getattr(training, name)
    box = {}

    def wrapped(*a, **kw):
        clock, box["p50"] = _step_clock()

        def hook(step):
            clock(step)
            if then is not None:
                then(step)

        return real(*a, **{**kw, "step_hook": hook})

    setattr(training, name, wrapped)
    try:
        yield lambda: box["p50"]() if "p50" in box else None
    finally:
        setattr(training, name, real)


def _cli_in_process(args: list, what: str) -> list:
    """``fast_tffm_tpu_torch.cli.main(args)`` in this process (the wrappers'
    counters see its launches), its stderr log kept and echoed."""
    from fast_tffm_tpu_torch import cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(args)
    lines = err.getvalue().splitlines()
    for line in lines:
        log_stderr(f"[{what}] {line}")
    if rc != 0:
        fail(f"{what}: cli {' '.join(args)} exited {rc}")
    return lines


B2_STOP = 12  # the stopped runs' SIGTERM step


def _b2_run(tmp: str, name: str, verb: str, paths: dict, fmt: str, *, stop_at=None,
            resume: bool = False, traced: bool = False, ini: str | None = None) -> dict:
    """One ``cli train`` / ``cli dist_train`` of baseline2 in this process:
    its own ``checkpoint_format`` (orbax) unless ``fmt`` is npz; SIGTERM
    after the call that reaches ``stop_at``; ``resume`` adds --resume.
    Returns its log, the wrappers' launches, step p50 and wall."""
    import torch

    if ini is None:
        general = {"model_file": os.path.join(tmp, name + (".orbax" if fmt == "orbax"
                                                           else ".ckpt"))}
        if fmt == "npz":
            general["checkpoint_format"] = "npz"
        ini = _write_ini(os.path.join(tmp, name + ".cfg"), B2_CONFIG, General=general,
                         Train={"train_files": paths["train"],
                                "validation_files": paths["valid"], "log_every": 4,
                                "metrics_path": os.path.join(tmp, name + ".jsonl")},
                         Predict={"predict_files": paths["valid"],
                                  "score_path": os.path.join(tmp, name + ".scores")})
    run = {"ini": ini}
    args = [verb, ini] + (["--resume"] if resume else [])
    what = name + ("_resumed" if resume else "")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    with _clocked(verb, _stop_hook(stop_at, []) if stop_at else None) as p50:
        if traced:
            window = traced_window(lambda: run.update(log=_cli_in_process(args, what)))
            for k in ("device_idle_share", "device_busy_ms", "wall_ms", "launches_traced"):
                run[k] = window[k]
        else:
            t1 = time.perf_counter()
            run["log"] = _cli_in_process(args, what)
            torch.cuda.synchronize()
            run["wall_ms"] = 1e3 * (time.perf_counter() - t1)
        run["step_ms_p50"] = p50()
    run["launches"] = _wrapper_counts()
    run["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    steps = (B2_STOP if stop_at else B2_TRAIN_BATCHES) - (B2_STOP if resume else 0)
    want = {"rows_tail_adagrad": steps, "fm2_fwd": steps, "fm2_bwd": steps}
    if not _launches_match(run["launches"], want):
        fail(f"{what}: kernel launches {run['launches']}, expected {want} (forwards at least)")
    run["losses"] = {int(m.group(1)): float(m.group(2)) for m in
                     (re.match(r"step (\d+) epoch \d+ loss ([0-9.]+)", line) for line in run["log"])
                     if m}
    run["examples_per_s_logged"] = _logged(run["log"], "examples/sec")
    run["examples_per_s_run"] = (steps * BATCH) / (run["wall_ms"] / 1e3)
    return run


def _b2_predict(verb: str, ini: str, what: str) -> dict:
    _zero_counters()
    t1 = time.perf_counter()
    _cli_in_process([verb, ini], what)
    return {"ms": 1e3 * (time.perf_counter() - t1), "launches": _wrapper_counts()}


def _b2_restores(npz: str, orbax: str) -> dict:
    """Each format's full restore onto the card, timed in turns (npz, orbax,
    orbax, npz; the files warm in the page cache from their writes), and
    the two states held bitwise equal on the card."""
    import torch

    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint

    times = {"npz": [], "orbax": []}
    states = {}
    for fmt in ("npz", "orbax", "orbax", "npz"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = restore_checkpoint(npz if fmt == "npz" else orbax, torch.device("cuda"),
                                accum_width=17)
        torch.cuda.synchronize()
        times[fmt].append(1e3 * (time.perf_counter() - t0))
        if fmt not in states:
            states[fmt] = st
        del st
    a, b = states["npz"], states["orbax"]
    if not (a.step == b.step and torch.equal(a.table, b.table)
            and torch.equal(a.table_accum, b.table_accum)):
        fail("dist_b2: the orbax directory read back is not bitwise its npz twin")
    del states, a, b
    torch.cuda.empty_cache()
    return {f"{k}_ms": v for k, v in times.items()}


def _save_rates(ckpt: list) -> list:
    return [dict(r, mb_per_s=r["bytes"] / 1e6 / (r["train_stall_ms"] / 1e3))
            for r in _stall(ckpt)]


def phase_dist_b2(tmp: str, jobs) -> dict:
    """configs/baseline2_fm_sharded.cfg at full width (order 2, k 16, V 2^24,
    max_nnz 39, batch 16,384) with its own checkpoint_format = orbax and
    log_every 4 (six logged losses to compare), every run in this process
    from the same fresh init: ``cli dist_train`` at world size 1 (no process
    group; traced) writes an orbax directory, ``cli train`` with npz its
    twin; ``cli dist_train`` and ``cli train`` with orbax stopped by SIGTERM
    at step 12 and resumed with --resume; ``cli dist_predict`` and ``cli
    predict`` from the directory against ``cli predict`` from the npz.  The
    logged losses, the saved 2^24 x 17 table and accumulator, the cursor
    and the score files bitwise; B4 once per step and no other kernel; each
    format's epoch save (stall, bytes, MB/s) and full restore (ms) side by
    side; step p50, ex/s, the card's idle share, peak device memory."""
    import numpy as np

    from fast_tffm_tpu_torch.checkpoint import read_input_cursor, restore_checkpoint
    from fast_tffm_tpu_torch.config import load_config

    t0 = time.perf_counter()
    paths = _wait_b2_data(jobs)
    data_s = time.perf_counter() - t0
    rec = {"phase": "dist_b2", "config": B2_CONFIG + " + log_every = 4",
           "data_wait_s": data_s}
    runs = {
        "train_npz": _b2_run(tmp, "b2_train_npz", "train", paths, "npz"),
        "dist_train": _b2_run(tmp, "b2_dist", "dist_train", paths, "orbax", traced=True),
    }
    for verb in ("dist_train", "train"):
        name = f"b2_{verb}_cut"
        runs[f"{verb}_stopped"] = _b2_run(tmp, name, verb, paths, "orbax", stop_at=B2_STOP)
        runs[f"{verb}_resumed"] = _b2_run(tmp, name, verb, paths, "orbax", resume=True,
                                          ini=runs[f"{verb}_stopped"]["ini"])
    cfgs = {k: load_config(r["ini"]) for k, r in runs.items()}
    # Each run's epoch save (before the predictions append to the metrics).
    saves = {"npz": _save_rates(_ckpt_records("b2_train_npz", cfgs["train_npz"].metrics_path,
                                              "sync")),
             "orbax": _save_rates(_ckpt_records("b2_dist", cfgs["dist_train"].metrics_path,
                                                "sync"))}
    whole = runs["dist_train"]
    if not os.path.isdir(cfgs["dist_train"].model_file) or cfgs["dist_train"].checkpoint_format != "orbax":
        fail("dist_b2: baseline2's run did not write an orbax directory")
    if len(whole["losses"]) != B2_TRAIN_BATCHES // 4 or whole["losses"] != runs["train_npz"]["losses"]:
        fail(f"dist_b2: logged losses {whole['losses']} against the npz twin's "
             f"{runs['train_npz']['losses']}")
    for verb in ("dist_train", "train"):
        stopped, resumed = runs[f"{verb}_stopped"], runs[f"{verb}_resumed"]
        if not any(f"stopped on signal at step {B2_STOP}" in ln for ln in stopped["log"]):
            fail(f"dist_b2 {verb}: no stop at step {B2_STOP}: {stopped['log'][-3:]}")
        if not any(f"at step {B2_STOP}" in ln and "resumed from" in ln for ln in resumed["log"]):
            fail(f"dist_b2 {verb}: the resumed run did not restore step {B2_STOP}")
        got = {**stopped["losses"], **resumed["losses"]}
        if set(whole["losses"]) - set(got) - {B2_STOP} or any(
                whole["losses"][s] != v for s, v in got.items()):
            fail(f"dist_b2 {verb}: stopped + resumed losses {got} against {whole['losses']}")
        cut_file = cfgs[f"{verb}_stopped"].model_file
        if read_input_cursor(cut_file) != read_input_cursor(cfgs["dist_train"].model_file):
            fail(f"dist_b2 {verb}: the resumed run's cursor is not the uninterrupted run's")
    import torch

    cpu = torch.device("cpu")
    ref = restore_checkpoint(cfgs["dist_train"].model_file, cpu, accum_width=17)
    for key in ("train_npz", "dist_train_stopped", "train_stopped"):
        got = restore_checkpoint(cfgs[key].model_file, cpu, accum_width=17)
        if not _logical_equal(got, ref):
            fail(f"dist_b2: {key}'s final state is not bitwise the orbax run's")
        del got
    shape = list(ref.table.shape)
    del ref
    # Scores: predict from the npz twin; dist_predict and predict from the
    # orbax directory (one process: the engine's full restore).
    preds = {"predict_npz": _b2_predict("predict", runs["train_npz"]["ini"], "b2_predict_npz"),
             "dist_predict_orbax": _b2_predict("dist_predict", whole["ini"],
                                               "b2_dist_predict_orbax")}
    with open(cfgs["train_npz"].score_path) as f:
        want = f.read()
    with open(cfgs["dist_train"].score_path) as f:
        if f.read() != want or len(want.splitlines()) != B2_VALID_ROWS:
            fail("dist_b2: dist_predict's scores from the orbax directory are not the npz's")
    preds["predict_orbax"] = _b2_predict("predict", whole["ini"], "b2_predict_orbax")
    with open(cfgs["dist_train"].score_path) as f:
        if f.read() != want:
            fail("dist_b2: predict's scores from the orbax directory are not the npz's")
    scores = np.loadtxt(io.StringIO(want))
    if not np.isfinite(scores).all():
        fail("dist_b2: non-finite scores")
    restores = _b2_restores(cfgs["train_npz"].model_file, cfgs["dist_train"].model_file)
    keep = ("launches", "losses", "step_ms_p50", "wall_ms", "examples_per_s_logged",
            "examples_per_s_run", "peak_device_bytes")
    for k, run in runs.items():
        rec[k] = {key: run[key] for key in keep}
    for k in ("device_idle_share", "device_busy_ms", "launches_traced"):
        rec["dist_train"][k] = whole[k]
    dir_bytes = sum(os.path.getsize(os.path.join(r, f))
                    for r, _, fs in os.walk(cfgs["dist_train"].model_file) for f in fs)
    rec.update(table_shape=shape, orbax_dir_bytes=dir_bytes, saves=saves, restores=restores,
               predict=preds, bitwise_losses=True, bitwise_table=True, bitwise_npz_twin=True,
               bitwise_resumed={"dist_train": True, "train": True}, bitwise_cursor=True,
               bitwise_scores=True, scores=int(scores.size), seconds=time.perf_counter() - t0)
    emit(rec)
    return {f"dist_b2_{k}" if k != "dist_train" else "dist_b2": r["launches"]
            for k, r in runs.items()}


def phase_orbax_fixture() -> dict:
    """The JAX-written fixture (tests/data/jax_b5_rowmesh: tools/
    make_orbax_fixture.py, the JAX package on a 2-way row mesh, zstd
    nodes and chunks) restored through the port onto the card from the
    orbax directory and from its npz twin: bitwise equal.  Needs libzstd."""
    import ctypes.util

    import torch

    from fast_tffm_tpu_torch.checkpoint import read_input_cursor, restore_checkpoint
    from fast_tffm_tpu_torch.ocdbt import OcdbtStore

    lib = ctypes.util.find_library("zstd")
    if lib is None:
        fail("orbax_fixture: libzstd is absent on this host; a JAX-written (zstd-compressed) "
             "orbax directory cannot be read")
    base = os.path.join(HERE, "tests", "data", "jax_b5_rowmesh")
    t0 = time.perf_counter()
    a = restore_checkpoint(base + ".orbax", torch.device("cuda"), accum_width=9)
    torch.cuda.synchronize()
    orbax_ms = 1e3 * (time.perf_counter() - t0)
    b = restore_checkpoint(base + ".npz", torch.device("cuda"), accum_width=9)
    if not (a.step == b.step and torch.equal(a.table, b.table)
            and torch.equal(a.table_accum, b.table_accum)
            and read_input_cursor(base + ".orbax") == read_input_cursor(base + ".npz")):
        fail("orbax_fixture: the JAX-written orbax directory is not bitwise its npz twin")
    chunks = [k for k in OcdbtStore(base + ".orbax").keys()
              if k.startswith("table/") and not k.endswith(".zarray")]
    emit({"phase": "orbax_fixture", "libzstd": lib, "table_shape": list(a.table.shape),
          "step": a.step, "table_chunks": chunks, "bitwise_npz_twin": True,
          "restore_ms": orbax_ms})
    return {"table_chunks": len(chunks)}


def _only_serve_reload_orbax(tmp: str) -> None:
    """serve_reload's orbax case on the fixture's states (``--only orbax``)."""
    import dataclasses

    import numpy as np
    import torch

    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint

    first = restore_checkpoint(os.path.join(HERE, "tests", "data", "jax_b5_rowmesh.orbax"),
                               torch.device("cpu"), accum_width=9)
    second = dataclasses.replace(first, table=first.table * 0.5, step=first.step + 1)
    cfg = _b5(vocabulary_size=first.table.shape[0], model_file=os.path.join(tmp, "o.orbax"))
    probe = _probe_block(np.random.default_rng(SEED + 9), cfg.vocabulary_size)
    emit({"phase": "serve_reload_orbax",
          **_serve_reload_orbax(tmp, cfg, probe, [first, second], [0])})


def phase_dist_b5(rng, tmp: str, train_path: str, valid_path: str) -> dict:
    """baseline5 (order 3) through ``training.dist_train`` at world size 1
    against ``training.train`` from one seeded npz, 24 steps each, on the
    rows layout, packed (B4 at the packed address), fused (B3),
    steps_per_call = 8 (a CUDA-graph replay; traced) and lookup = alltoall:
    the logged losses and the logical table and accumulator bitwise; B1,
    B2 and the layout's tail once per step in each run."""
    import dataclasses

    from fast_tffm_tpu_torch.config import build_model
    from fast_tffm_tpu_torch.parallel import gather_logical_state, make_mesh
    from fast_tffm_tpu_torch.trainer import unpack_state

    cases = {
        "rows": {},
        "packed": {"table_layout": "packed"},
        "fused": {"table_layout": "packed", "adagrad_accumulator": "fused"},
        "k8": {"steps_per_call": 8},
        "alltoall": {"lookup": "alltoall"},
    }
    t0 = time.perf_counter()
    files = dict(train_files=(train_path,), validation_files=(valid_path,), log_every=4)
    rec, observed = {"phase": "dist_b5", "config": CONFIG, "steps": TRAIN_BATCHES}, {}
    for case, kw in cases.items():
        base = _b5(**kw)
        model = build_model(base)
        fused = kw.get("adagrad_accumulator") == "fused"
        _, _, init = _seeded_init(rng, tmp, f"dist_b5_{case}", base, model, fused)
        outs = {}
        for entry in ("train", "dist_train"):
            cfg = _phase_cfg(base, tmp, f"dist_b5_{case}_{entry}", "cuda", init, **files)
            outs[entry] = _run(f"dist_b5 {case} {entry}", cfg, entry=entry,
                                trace=base.steps_per_call > 1)
            tail = "fused_tail_adagrad" if fused else "rows_tail_adagrad"
            _expect_steps(f"dist_b5 {case} {entry}", outs[entry]["launches"],
                          TRAIN_BATCHES, tail)
        a = unpack_state(outs["train"]["state"], model)
        b = gather_logical_state(outs["dist_train"]["state"], model, make_mesh())
        v = base.vocabulary_size
        b = dataclasses.replace(b, table=b.table[:v], table_accum=b.table_accum[:v])
        if _logged(outs["train"]["log"], "loss") != _logged(outs["dist_train"]["log"], "loss") \
                or not _logical_equal(a, b):
            fail(f"dist_b5 {case}: dist_train is not bitwise train")
        observed[f"dist_b5_{case}"] = outs["dist_train"]["launches"]
        rec[case] = {"bitwise": True, "launches": outs["dist_train"]["launches"],
                     "train_launches": outs["train"]["launches"],
                     "wall_ms": {d: o["wall_ms"] for d, o in outs.items()},
                     "device_idle_share": outs["dist_train"].get("device_idle_share")}
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return observed


def _gathered_world(rng, ids, d: int, ranks: int, vocab: int):
    """The world-gathered ``(uids, gsum)`` of ``ranks`` synthetic ranks: the
    batch's ids split into their B / P slices, random gradients, each
    slice deduped and padded to M with the sentinel ``vocab``
    (``dedup_rows_padded``), concatenated in rank order."""
    import torch

    from fast_tffm_tpu_torch.parallel.embedding import dedup_rows_padded

    parts = torch.chunk(torch.from_numpy(ids), ranks)
    u, g = [], []
    for p in parts:
        grads = torch.from_numpy(rng.standard_normal((p.numel(), d)).astype("float32"))
        uids, gsum = dedup_rows_padded(p.reshape(-1), grads, vocab)
        u.append(uids)
        g.append(gsum)
    return torch.cat(u), torch.cat(g)


def phase_shard_update(rng, train_path: str) -> dict:
    """The sharded update's apply on the card, at R = 2 and R = 4 with no
    process group: one seeded [2^20, 9] table cut into R shards, the
    world-gathered (uids, gsum) of R synthetic ranks from the first batch
    (unowned ids and sentinels included); each shard's apply (B4 at base >
    0: ``apply_shard_adagrad``) bitwise its plain twin on the CPU and the
    R = 1 update's rows; B4 at the packed address and B3 on each shard's
    packed and fused forms bitwise the rows kernel's logical result (element
    and row accumulators); ``_bucketize`` and the routed send buffers on the
    card equal to the CPU's.  The shard applies' times by CUDA events."""
    import numpy as np
    import torch

    from fast_tffm_tpu_torch.ops.packed_table import (
        fused_rows_per_tile,
        pack_accum_any,
        pack_fused,
        pack_table,
        rows_per_tile,
        unpack_accum_any,
        unpack_fused,
        unpack_table,
    )
    from fast_tffm_tpu_torch.ops.tail import fused_tail_adagrad_update, rows_tail_adagrad_update
    from fast_tffm_tpu_torch.parallel.alltoall import _bucketize, _send
    from fast_tffm_tpu_torch.parallel.embedding import apply_shard_adagrad, owned_local_ids

    t0 = time.perf_counter()
    v, d, lr = 1 << 20, 9, 0.05
    ids = _first_batch_ids(train_path, v)
    table = torch.from_numpy(rng.uniform(-0.01, 0.01, (v, d)).astype(np.float32))
    rec = {"phase": "shard_update", "V": v, "D": d, "M": int(ids.size)}
    for ranks in (2, 4):
        uids, gsum = _gathered_world(rng, ids, d, ranks, v)
        out = {"Q": int(uids.numel()), "sentinels": int((uids >= v).sum())}
        for acc_w in (d, 1):
            accum = torch.full((v, acc_w), 0.1)
            whole_t, whole_a = table.clone().cuda(), accum.clone().cuda()
            apply_shard_adagrad(whole_t, whole_a, uids.cuda(), gsum.cuda(), lr, 0)
            shard = v // ranks
            times = []
            for r in range(ranks):
                lo = r * shard
                got_t, got_a = table[lo:lo + shard].clone().cuda(), accum[lo:lo + shard].clone().cuda()
                twin_t, twin_a = table[lo:lo + shard].clone(), accum[lo:lo + shard].clone()
                apply_shard_adagrad(got_t, got_a, uids.cuda(), gsum.cuda(), lr, lo)
                apply_shard_adagrad(twin_t, twin_a, uids, gsum, lr, lo)
                if not (torch.equal(got_t.cpu(), twin_t) and torch.equal(got_a.cpu(), twin_a)
                        and torch.equal(got_t, whole_t[lo:lo + shard])
                        and torch.equal(got_a, whole_a[lo:lo + shard])):
                    fail(f"shard_update R={ranks} shard {r} (accum width {acc_w}): the card's "
                         "apply is not bitwise its twin and the R = 1 update")
                p = rows_per_tile(d)
                past = -(-shard // p) * p
                loc32, _ = owned_local_ids(uids.long().cuda(), shard, r, past)
                loc32 = loc32.to(torch.int32)
                pt = pack_table(table[lo:lo + shard].clone().cuda())
                pa = pack_accum_any(accum[lo:lo + shard].clone().cuda(), d, 0.1)
                rows_tail_adagrad_update(pt, pa, loc32, gsum.cuda(), lr, packed=True)
                if not (torch.equal(unpack_table(pt, shard, d), got_t)
                        and torch.equal(unpack_accum_any(pa, shard, d), got_a)):
                    fail(f"shard_update R={ranks} shard {r}: B4 packed is not the rows result")
                if acc_w == 1:
                    pf = fused_rows_per_tile(d)
                    fpast = -(-shard // pf) * pf
                    floc, _ = owned_local_ids(uids.long().cuda(), shard, r, fpast)
                    fz = pack_fused(table[lo:lo + shard].clone().cuda(),
                                    accum[lo:lo + shard].clone().cuda(), 0.1)
                    fused_tail_adagrad_update(fz, floc.to(torch.int32), gsum.cuda(), lr)
                    ft, fa = unpack_fused(fz, shard, d)
                    if not (torch.equal(ft, got_t) and torch.equal(fa, got_a)):
                        fail(f"shard_update R={ranks} shard {r}: B3 is not the rows result")
                t_, a_ = table[lo:lo + shard].clone().cuda(), accum[lo:lo + shard].clone().cuda()
                u_, g_ = uids.cuda(), gsum.cuda()
                times.append(time_ms(lambda: apply_shard_adagrad(t_, a_, u_, g_, lr, lo), 5))
            out[f"accum_{'element' if acc_w == d else 'row'}"] = {
                "bitwise": True, "apply_ms_per_shard": times}
        owner = (uids.long() // (v // ranks)).clamp(max=ranks)
        cap = max(8, int(owner.numel() // ranks))
        b_cpu = _bucketize(owner, ranks, cap)
        b_gpu = _bucketize(owner.cuda(), ranks, cap)
        same = all(torch.equal(x, y.cpu()) for x, y in zip(b_cpu, b_gpu))
        s_cpu = _send(uids[b_cpu[0]], v, b_cpu[1], b_cpu[2], ranks, cap)
        s_gpu = _send(uids.cuda()[b_gpu[0]], v, b_gpu[1], b_gpu[2], ranks, cap)
        if not (same and torch.equal(s_cpu, s_gpu.cpu())):
            fail(f"shard_update R={ranks}: the card's routing buffers differ from the CPU's")
        out["routing_equal"] = True
        out["routing_overflow"] = bool(b_cpu[4])
        rec[f"R{ranks}"] = out
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)


def phase_nccl_world1(rng, train_path: str) -> dict:
    """An NCCL process group of world size 1 on the card (tcp store on
    localhost).  The general (R > 1-shaped) branches, through a mesh with
    its fast paths off, against the fast path, bitwise: ``sharded_gather``,
    ``sharded_sparse_adagrad_update``, ``routed_gather`` / ``routed_update``
    directly; then the sharded train step (baseline5, order 3) eagerly and
    as a captured 4-step CUDA graph, allgather and alltoall, against the
    single-device step on the same batches.  The only NCCL run a one-card
    host allows."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from fast_tffm_tpu_torch.config import build_model
    from fast_tffm_tpu_torch.data.pipeline import batch_stream
    from fast_tffm_tpu_torch.distributed import free_port
    from fast_tffm_tpu_torch.models.base import Batch
    from fast_tffm_tpu_torch.ops.tail import rows_tail_adagrad_update
    from fast_tffm_tpu_torch.parallel import Mesh, make_sharded_train_step
    from fast_tffm_tpu_torch.parallel.alltoall import capacity_for, routed_gather, routed_update
    from fast_tffm_tpu_torch.parallel.embedding import sharded_gather, sharded_sparse_adagrad_update
    from fast_tffm_tpu_torch.trainer import init_state

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    rec = {"phase": "nccl_world1", "backend": dist.get_backend()}
    try:
        general, fast = Mesh(fast_paths=False), Mesh()
        v, d, lr = 1 << 20, 9, 0.05
        ids = torch.from_numpy(_first_batch_ids(train_path, v)).cuda()
        table = torch.from_numpy(rng.uniform(-0.01, 0.01, (v, d)).astype(np.float32)).cuda()
        grads = torch.from_numpy(rng.standard_normal((*ids.shape, d)).astype(np.float32)).cuda()
        if not torch.equal(sharded_gather(table, ids, general), table[ids]):
            fail("nccl_world1: the general sharded_gather is not table[ids]")
        cap = capacity_for(ids.numel(), 1, 2.0)
        if not torch.equal(routed_gather(table, ids, cap, general), table[ids]):
            fail("nccl_world1: routed_gather is not table[ids]")
        ref_t, ref_a = table.clone(), torch.full_like(table, 0.1)
        rows_tail_adagrad_update(ref_t, ref_a, ids, grads, lr)
        for name, update in (
                ("sharded_sparse_adagrad_update",
                 lambda t, a: sharded_sparse_adagrad_update(t, a, ids, grads, lr, v, general)),
                ("routed_update",
                 lambda t, a: routed_update(t, a, ids, grads, lr, v, cap, general))):
            t, a = table.clone(), torch.full_like(table, 0.1)
            update(t, a)
            if not (torch.equal(t, ref_t) and torch.equal(a, ref_a)):
                fail(f"nccl_world1: the general {name} is not the fast path's update")
        rec["direct"] = {"gather": True, "routed_gather": True, "update": True,
                         "routed_update": True}
        base = _b5()
        model = build_model(base)
        stream = batch_stream([train_path], batch_size=BATCH, vocabulary_size=v, max_nnz=NNZ)
        batches = [Batch.from_parsed(*next(stream)) for _ in range(4)]
        superbatch = Batch(*(torch.stack([getattr(b, f.name) for b in batches])
                             for f in dataclasses.fields(Batch)))
        init = init_state(model, torch.Generator(device="cuda").manual_seed(0))
        for lookup in ("allgather", "alltoall"):
            for k in (1, 4):
                states, losses = {}, {}
                for label, mesh in (("fast", fast), ("general", general)):
                    st = dataclasses.replace(
                        init, table=init.table.clone(), table_accum=init.table_accum.clone())
                    step = make_sharded_train_step(model, base.learning_rate, mesh,
                                                   lookup=lookup, steps_per_call=k,
                                                   overflow_mode="fallback")
                    if k == 1:
                        out = []
                        for b in batches:
                            st, loss = step(st, b.to("cuda"))
                            out.append(loss)
                        losses[label] = torch.stack(out)
                    else:
                        st, losses[label] = step(st, superbatch)
                        if step.graphs.captures != 1:
                            fail(f"nccl_world1: {lookup} k{k} {label} made "
                                 f"{step.graphs.captures} graph captures")
                    states[label] = st
                if not (torch.equal(losses["fast"], losses["general"])
                        and torch.equal(states["fast"].table, states["general"].table)
                        and torch.equal(states["fast"].table_accum,
                                        states["general"].table_accum)):
                    fail(f"nccl_world1: the general {lookup} step (k{k}) is not the fast path's")
                rec[f"{lookup}_k{k}"] = {"bitwise": True,
                                         "losses": losses["general"].cpu().tolist()}
    finally:
        dist.destroy_process_group()
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)


def _resident_mib(lines: list) -> float | None:
    """The resident epoch's size from the run's ``device cache: ...`` line."""
    for line in lines:
        m = re.search(r"device cache: .*\(([0-9.]+) MiB", line)
        if m:
            return float(m.group(1))
    return None


def phase_dist_cached(rng, tmp: str, train_path: str, valid_path: str, big_path: str) -> dict:
    """baseline5 at full width through ``training.dist_train`` with
    ``device_cache = true`` at world size 1 (FMB input, ``binary_cache``),
    each run against ``training.train`` with ``device_cache`` on the same
    config and init: rows K = 1 over the 393,216-row file (24 steps, a loss
    logged every step, a fresh seeded init, traced: pod_card's reference), rows
    K = 8 and fused K = 8 over the config's 1,048,576-row epoch (64 steps,
    traced: the replays counted in the trace), and rows K = 1 with
    delta_every_steps = 4 stopped by SIGTERM at step 10 and resumed.  Every
    logged loss, the logical table and accumulator and the stopped run's
    cursor bitwise; B1, B2 and the layout's tail once per step.  Then the
    cached sharded step through an NCCL group of world size 1 with the mesh's
    fast paths off (the general branches, the collectives inside the K = 8
    graph) against the fast path, bitwise.  Step p50 eager and graphed, the
    card's idle share, the resident bytes."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from fast_tffm_tpu_torch.checkpoint import read_input_cursor
    from fast_tffm_tpu_torch.config import build_model
    from fast_tffm_tpu_torch.data import device_cache
    from fast_tffm_tpu_torch.data.binary import ensure_fmb_cache
    from fast_tffm_tpu_torch.data.native import best_parser
    from fast_tffm_tpu_torch.distributed import free_port
    from fast_tffm_tpu_torch.parallel import Mesh, gather_logical_state, make_mesh
    from fast_tffm_tpu_torch.trainer import init_state, unpack_state

    t0 = time.perf_counter()
    train24, valid = _own_files(tmp, "dist_cached", train_path, valid_path)
    (big,) = _own_files(tmp, "dist_cached", big_path)
    cache = {"device_cache": True, "binary_cache": True}
    # rows_k1 runs 4 epochs, so that pod_card's bump after step 8 leaves
    # its child most of the run to notice it in.
    cases = {
        "rows_k1": dict(files=(train24,), steps=POD_EPOCHS * TRAIN_BATCHES,
                        kw={"log_every": 1, "epoch_num": POD_EPOCHS}, fresh=True, trace=True),
        "rows_k8": dict(files=(big,), steps=THROUGHPUT_BATCHES,
                        kw={"steps_per_call": 8, "log_every": 8}),
        "fused_k8": dict(files=(big,), steps=THROUGHPUT_BATCHES,
                         kw={"steps_per_call": 8, "log_every": 8, **FUSED}),
        "rows_k1_delta": dict(files=(train24,), steps=TRAIN_BATCHES,
                              kw={"log_every": 4, "delta_every_steps": 4}, stop_at=10),
    }
    rec = {"phase": "dist_cached", "config": CONFIG + " + " + json.dumps(cache)}
    observed, pod_ref = {}, {}
    for path in (train24, big):  # the caches first: no run pays their build
        ensure_fmb_cache((path,), vocabulary_size=1 << 20, max_nnz=NNZ,
                         parser=best_parser(8), log=log_stderr)
    for case, spec in cases.items():
        base = _b5(**cache, **spec["kw"])
        model = build_model(base)
        fused = base.adagrad_accumulator == "fused"
        tail = "fused_tail_adagrad" if fused else "rows_tail_adagrad"
        _, _, init = _seeded_init(rng, tmp, f"dist_cached_{case}", base, model, fused)
        files = dict(train_files=spec["files"], validation_files=(valid,))
        outs, p50s, cursors = {}, {}, {}
        for entry in ("train", "dist_train"):
            name = f"dist_cached_{case}_{entry}"
            cfg = _phase_cfg(base, tmp, name, "cuda", init, metrics_path=os.path.join(
                tmp, name + ".jsonl"), **files)
            clocks = {}

            def make_clock(clocks=clocks):
                hook, clocks["p50"] = _step_clock()
                return hook

            resume = not spec.get("fresh")
            if spec.get("stop_at"):
                fired = []
                first = _run(f"{name} stop", cfg, hook=_stop_hook(spec["stop_at"], fired),
                             resume=resume, entry=entry)
                cursors[entry] = read_input_cursor(cfg.model_file)
                if first["state"].step != spec["stop_at"]:
                    fail(f"{name}: stopped at step {first['state'].step}")
                _expect_steps(f"{name} stop", first["launches"], spec["stop_at"], tail)
                out = _run(f"{name} resumed", cfg, make_hook=make_clock, resume=True,
                           entry=entry)
                _expect_steps(f"{name} resumed", out["launches"],
                              spec["steps"] - spec["stop_at"], tail)
                out["log"] = first["log"] + out["log"]
                out["launches"] = {k: first["launches"][k] + out["launches"][k]
                                   for k in KERNELS}
            else:
                out = _run(name, cfg, make_hook=make_clock, resume=resume, entry=entry,
                           trace=base.steps_per_call > 1 or spec.get("trace", False))
                _expect_steps(name, out["launches"], spec["steps"], tail)
            outs[entry], p50s[entry] = out, clocks["p50"]()
        a = unpack_state(outs["train"]["state"], model)
        b = gather_logical_state(outs["dist_train"]["state"], model, make_mesh())
        v = base.vocabulary_size
        b = dataclasses.replace(b, table=b.table[:v], table_accum=b.table_accum[:v])
        losses = [_records_losses(o["cfg"].metrics_path) for o in outs.values()]
        if not losses[0] or losses[0] != losses[1] or not _logical_equal(a, b) \
                or cursors.get("train") != cursors.get("dist_train"):
            fail(f"dist_cached {case}: dist_train is not bitwise train "
                 f"(cursors {cursors})")
        dist_out = outs["dist_train"]
        observed[f"dist_cached_{case}"] = dist_out["launches"]
        per_call = base.steps_per_call
        rec[case] = {
            "bitwise": True, "steps": spec["steps"], "launches": dist_out["launches"],
            "train_launches": outs["train"]["launches"],
            "step_ms_p50": {e: None if p is None else p / per_call for e, p in p50s.items()},
            "graphed": per_call > 1,
            "wall_ms": {e: o["wall_ms"] for e, o in outs.items()},
            "device_idle_share": dist_out.get("device_idle_share"),
            "device_busy_ms": dist_out.get("device_busy_ms"),
            "resident_mib": _resident_mib(dist_out["log"]),
            "examples_per_s_run": spec["steps"] * BATCH / (dist_out["wall_ms"] / 1e3),
        }
        if spec.get("stop_at"):
            rec[case]["cursor"] = cursors["dist_train"]
        if case == "rows_k1":
            pod_ref.update(model_file=dist_out["cfg"].model_file,
                           metrics_path=dist_out["cfg"].metrics_path, **files)
    # The general branches (R > 1-shaped) of the cached sharded step through
    # a real NCCL group, eager and as one captured K = 8 graph.
    base = _b5()
    model = build_model(base)
    fmb = ensure_fmb_cache((train24,), vocabulary_size=base.vocabulary_size, max_nnz=NNZ,
                           log=log_stderr)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        init = init_state(model, torch.Generator(device="cuda").manual_seed(0))
        for k in (1, 8):
            states, losses = {}, {}
            for label, mesh in (("fast", Mesh()), ("general", Mesh(fast_paths=False))):
                data = device_cache.load_sharded_device_dataset(
                    fmb, mesh=mesh, batch_size=BATCH, vocabulary_size=base.vocabulary_size,
                    max_nnz=NNZ, device="cuda")
                step = device_cache.make_cached_sharded_train_step(
                    model, base.learning_rate, mesh, data, steps_per_call=k)
                st = dataclasses.replace(init, table=init.table.clone(),
                                         table_accum=init.table_accum.clone())
                items = (device_cache.epoch_index_chunks(8, k, "cuda") if k > 1 else
                         [torch.tensor(i, device="cuda") for i in range(8)])
                out = []
                for i in items:
                    st, loss = step(st, i)
                    out.append(loss.reshape(-1))
                if k > 1 and step.graphs.captures != 1:
                    fail(f"dist_cached nccl k{k} {label}: {step.graphs.captures} captures")
                states[label], losses[label] = st, torch.cat(out)
            if not (torch.equal(losses["fast"], losses["general"])
                    and torch.equal(states["fast"].table, states["general"].table)
                    and torch.equal(states["fast"].table_accum, states["general"].table_accum)):
                fail(f"dist_cached: the general cached step (k{k}) is not the fast path's")
            rec[f"nccl_general_k{k}"] = {"bitwise": True, "steps": 8}
    finally:
        dist.destroy_process_group()
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return observed, pod_ref


def _records_losses(path: str) -> dict:
    """step -> the last logged loss of a run's kind=train records."""
    return {r["step"]: r["loss"] for r in _records(path) if r["kind"] == "train"}


def phase_pod_card(tmp: str, ref: dict, smi: str) -> dict:
    """A one-host pod on the card, supervised by this script through the
    port's own functions: generation 0 in ``generation.json`` (a free port,
    num_processes 1) and the FM_DIST_* environment, then ``python -m
    fast_tffm_tpu_torch.cli dist_train`` on cuda (baseline5, device_cache,
    delta_every_steps 4, log_every 1, host_stall_timeout_s 5, runtime_dir
    set; a fresh seeded init).  After the child logs step 8 and its step-8
    delta is the chain head, the file goes to generation 1: the child must
    re-exec in place (the same PID, its
    environment the new generation's, ``--resume`` on its command line),
    join generation 1, restore the chain head on the card (a "resumed
    from" line after the join, at a delta boundary at or past step 8, and
    the first new step line the step after it) and finish with exit 0, every step's last-logged loss and the final table and
    accumulator bitwise dist_cached's rows K = 1 run, and ``hb-0.json`` at
    the last step.  The wall from the bump to the first new step line.  The
    child is a process of its own: its launches are not counted here."""
    import threading

    import numpy as np

    from fast_tffm_tpu_torch.distributed import (
        free_port,
        read_generation,
        read_heartbeat,
        write_generation,
    )

    t0 = time.perf_counter()
    rdir = os.path.join(tmp, "pod_card.dist")
    model_file = os.path.join(tmp, "pod_card.ckpt")
    metrics = os.path.join(tmp, "pod_card.jsonl")
    ini = _write_ini(
        os.path.join(tmp, "pod_card.cfg"),
        General={"model_file": model_file},
        Train={"train_files": ref["train_files"][0],
               "validation_files": ref["validation_files"][0], "epoch_num": POD_EPOCHS,
               "device_cache": "true", "binary_cache": "true", "log_every": 1,
               "metrics_path": metrics},
        Checkpoint={"delta_every_steps": POD_DELTA_EVERY},
        Distributed={"host_stall_timeout_s": 5, "runtime_dir": rdir, "heartbeat_s": 0.5},
    )
    write_generation(rdir, {"generation": 0, "coordinator": f"127.0.0.1:{free_port()}",
                            "num_processes": 1, "cause": "chip_smoke start"})
    env = dict(os.environ, FM_DIST_RUNTIME_DIR=rdir, FM_DIST_PROCESS_ID="0",
               FM_DIST_PROCESSES="1", FM_DIST_GENERATION="0")
    proc = subprocess.Popen([sys.executable, "-m", "fast_tffm_tpu_torch.cli", "dist_train", ini,
                             "--device", "cuda"], cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, marks = [], {}

    def bump():
        # The bump waits until the step-8 delta is the chain head: the child's
        # watcher re-execs at once, and a bump that beat the delta's publish
        # would send the child back to step 4 (the check below wants >= 8).
        from fast_tffm_tpu_torch.checkpoint import latest_step

        deadline = time.monotonic() + 120
        while (latest_step(model_file) or 0) < 8 and time.monotonic() < deadline:
            time.sleep(0.005)
        write_generation(rdir, {"generation": 1, "coordinator": f"127.0.0.1:{free_port()}",
                                "num_processes": 1, "cause": "chip_smoke bump"})
        marks["bump"] = time.perf_counter()

    bumper = threading.Thread(target=bump, daemon=True)

    def read():
        for line in proc.stdout:
            line = line.rstrip("\n")
            lines.append(line)
            log_stderr(f"[pod_card] {line}")
            now = time.perf_counter()
            if line.startswith("step 8 ") and "step_8" not in marks:
                marks["step_8"] = now
                bumper.start()
            elif "re-exec'ing into the new pod generation" in line:
                marks.setdefault("reexec_logged", now)
            elif "joining pod generation 1" in line:
                marks.setdefault("joined", now)
                marks["environ"] = _proc_environ(proc.pid)
                marks["cmdline"] = _proc_cmdline(proc.pid)
            elif line.startswith("step ") and "joined" in marks:
                marks.setdefault("first_new_step", now)
                marks.setdefault("first_new_step_line", line)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail("pod_card: the child did not finish in 600 s")
    finally:
        reader.join(timeout=30)
        if bumper.ident is not None:
            bumper.join(timeout=130)
    if rc != 0:
        fail(f"pod_card: the child exited {rc}")
    for key in ("bump", "reexec_logged", "joined", "first_new_step"):
        if key not in marks:
            fail(f"pod_card: no {key} seen in the child's output")
    environ, cmdline = marks.get("environ") or {}, marks.get("cmdline") or []
    if environ.get("FM_DIST_GENERATION") != "1" or cmdline[-1:] != ["--resume"]:
        fail(f"pod_card: pid {proc.pid} after the bump: generation "
             f"{environ.get('FM_DIST_GENERATION')}, command line {cmdline}")
    if read_generation(rdir)["generation"] != 1:
        fail("pod_card: generation.json is not at generation 1")
    got, want = _records_losses(metrics), _records_losses(ref["metrics_path"])
    if not want or any(got.get(s) != loss for s, loss in want.items()):
        fail(f"pod_card: the losses are not dist_cached rows_k1's: {got} against {want}")
    with np.load(model_file) as za, np.load(ref["model_file"]) as zb:
        for key in ("table", "table_accum", "step"):
            if not np.array_equal(za[key], zb[key]):
                fail(f"pod_card: the final {key} is not dist_cached rows_k1's")
        step = int(za["step"])
    hb, _ = read_heartbeat(rdir, 0)
    if not hb or hb.get("step") != step:
        fail(f"pod_card: hb-0.json {hb}, the run ended at step {step}")
    # The re-exec'd image restored the chain head: a "resumed from" line
    # after the join, at a delta boundary at or past the bump's step 8,
    # and the first new step the one after it.
    joined_at = next(i for i, line in enumerate(lines) if "joining pod generation 1" in line)
    restored = [line for line in lines[joined_at:] if line.startswith("resumed from")]
    m = re.search(r" at step (\d+)", restored[0]) if restored else None
    head = int(m.group(1)) if m else None
    if head is None or head < 8 or head % POD_DELTA_EVERY or head >= step:
        fail(f"pod_card: no restore of a delta boundary >= 8 after the join: {restored}")
    if not marks["first_new_step_line"].startswith(f"step {head + 1} "):
        fail(f"pod_card: restored step {head}, first new step line "
             f"{marks['first_new_step_line']!r}")
    rec = {"phase": "pod_card", "card": smi, "pid": proc.pid, "exit_code": rc,
           "same_pid_reexec": True, "generation_environ": environ.get("FM_DIST_GENERATION"),
           "cmdline_after": cmdline, "restored": restored, "restored_step": head,
           "first_new_step_line": marks["first_new_step_line"],
           "bump_to_reexec_log_s": marks["reexec_logged"] - marks["bump"],
           "bump_to_join_s": marks["joined"] - marks["bump"],
           "bump_to_first_new_step_s": marks["first_new_step"] - marks["bump"],
           "bitwise_dist_cached_rows_k1": True, "heartbeat": hb, "steps": step,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


def _proc_environ(pid: int) -> dict:
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            raw = f.read()
    except OSError:
        return {}
    return dict(kv.decode(errors="replace").split("=", 1) for kv in raw.split(b"\0")
                if b"=" in kv)


def _proc_cmdline(pid: int) -> list:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return [a.decode(errors="replace") for a in f.read().split(b"\0") if a]
    except OSError:
        return []


# --- the measuring drivers: bench_torch.py, bench_all_torch.py, tools/torch_loadgen.py
#
# Each runs as a subprocess of its own from the checkout, as a user runs it;
# its full output goes to chiprun_out/drivers/ and its result is held here.

DRIVERS_OUT = os.path.join(HERE, "chiprun_out", "drivers")
TOOLS_OUT = os.path.join(HERE, "chiprun_out", "tools")
TOOLS_PROBE_VOCAB, TOOLS_PROBE_STEPS = 2**31 - 1, 8  # past the card: 85.9 GB resident
# bench_torch's keys that must carry a number.
BENCH_NONNULL = ("value", "scale_value", "packed_value", "packed_b65536_value",
                 "zipf_interleaved_value", "device_cached_value", "toy_vocab1m_value")
# The fit line's train AUC (5k rows overfitted for 40 epochs): the CPU tests
# reach 0.998 at 1k rows and 10 epochs; a kernel, gradient or optimizer
# fault caps it far lower.
FIT_AUC_MIN = 0.99
LOADGEN_S = 5.0  # seconds of traffic per loadgen run
# Closed-loop workers: enough to fill the engine's flushes (at 8, the
# default, each 5 ms flush deadline waits on 8 requests and the rate is
# the workers', not the engine's); each socket worker holds a connection.
CLOSED_INPROCESS, CLOSED_SOCKET = 256, 64
JSONL_QPS = 200.0  # under the 287–615 lines/s the socket tier's JSONL path ran at
ZIPF_BATCH, ZIPF_NNZ, ZIPF_PACKED_VOCAB = 65536, 39, 1 << 24


def _start_driver(args: list, env=None):
    """``python <args>`` from the checkout, started in a session of its own."""
    os.makedirs(DRIVERS_OUT, exist_ok=True)
    os.makedirs(TOOLS_OUT, exist_ok=True)
    return subprocess.Popen([sys.executable, *args], cwd=HERE, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True), time.perf_counter()


def _driver(what: str, args: list, timeout: float, env=None, started=None, out_dir=None):
    """``python <args>`` (or the ``started`` one) to its end, killed whole at
    ``timeout`` (a spawned tier goes with it); its stdout and stderr kept
    under ``out_dir`` (DRIVERS_OUT).  Returns (returncode, stdout, seconds)."""
    proc, t0 = started or _start_driver(args, env)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{what}: no result within {timeout:.0f} s")
    seconds = time.perf_counter() - t0
    for ext, text in (("out", out), ("err", err)):
        with open(os.path.join(out_dir or DRIVERS_OUT, f"{what}.{ext}"), "w") as f:
            f.write(text)
    if proc.returncode != 0:
        log_stderr(err[-3000:])
    return proc.returncode, out, seconds


def _last_json(text: str, what: str) -> dict:
    for line in reversed(text.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    fail(f"{what}: printed no JSON line")


def phase_bench() -> dict:
    """bench_torch.py from the checkout (the full ladder, largest-first from
    1.5·2^30 rows: ~40 s of command): exit 0, no ``*_error``, every
    BENCH_NONNULL key a number, every ``scale_fallbacks`` entry an
    out-of-memory error, ``scale_implied_over_nominal`` <= 1.05."""
    from bench_torch import section_errors

    rc, out, seconds = _driver("bench_torch", ["bench_torch.py"], 900)
    r = _last_json(out, "bench_torch.py")
    errors = section_errors(r)
    if rc != 0 or errors:
        fail(f"bench_torch.py exited {rc}, failed sections {errors}")
    nulls = [k for k in BENCH_NONNULL if r.get(k) is None]
    if nulls:
        fail(f"bench_torch.py: no number for {nulls}")
    odd = [f for f in r.get("scale_fallbacks", []) if "out of memory" not in f]
    if odd:
        fail(f"bench_torch.py: a rung failed for another reason than memory: {odd}")
    if r.get("steps_per_call_vocab_rows") != r.get("scale_vocab_rows") or "8" not in (
            r.get("steps_per_call_values") or {}):
        fail(f"bench_torch.py: the K-step leg ran on {r.get('steps_per_call_vocab_rows')} rows "
             f"(the rung: {r.get('scale_vocab_rows')}), K values "
             f"{sorted(r.get('steps_per_call_values') or {})}")
    extra, state = r.get("steps_per_call_peak_over_state_gib"), r.get("steps_per_call_state_gib")
    if extra is None or extra >= 0.25 * state:
        fail(f"bench_torch.py: the K-step capture's peak is {extra} GiB above the live "
             f"{state} GiB state (a second copy of the state?)")
    over = r.get("scale_implied_over_nominal")
    if over is None or over > 1.05:
        fail(f"bench_torch.py: scale_implied_over_nominal {over} (the card's nominal "
             "bandwidth cannot carry the measured rate; or no nominal for this card)")
    keys = ("value", "metric", "scale_value", "scale_b16384_value", "scale_vocab_rows",
            "scale_max_rows", "scale_table_gib", "scale_state_gib", "scale_peak_device_gib",
            "scale_fallbacks", "scale_step_time_us", "scale_implied_hbm_gbps_floor",
            "scale_implied_over_nominal", "zipf_interleaved_value", "uniform_ids_value",
            "uniform_over_zipf", "fmb_streamed_value", "wire_format_ab_allones", "sharded_value",
            "device_cached_value", "steps_per_call_values", "steps_per_call_k8_over_k1",
            "steps_per_call_vocab_rows", "steps_per_call_state_gib",
            "steps_per_call_peak_over_state_gib",
            "packed_value", "packed_b65536_value", "packed_implied_hbm_gbps_floor",
            "ckpt_stall_ms_per_save", "toy_vocab1m_value", "card", "kernel_launches")
    emit({"phase": "bench", "seconds": seconds, **{k: r.get(k) for k in keys}})
    return r


def _zipf_timings(kern: str, kernel, update, plain) -> dict:
    return {
        "ms": time_ms(kernel, 30),
        "device_ms": device_ms(kernel, 10, kern),
        "device_ms_flushed": device_ms(flushed(kernel), 10, kern),
        "update_ms": time_ms(update, 30),
        "plain_ms": time_ms(plain, 10),
    }


def _bits_sum(t, chunk: int = 1 << 20) -> int:
    """The sum of a float32 tensor's bit patterns as int64, chunk by chunk
    of rows (exact across chunks): the digest that shows a write anywhere."""
    import torch

    return sum(int(t[i:i + chunk].view(torch.int32).sum(dtype=torch.int64))
               for i in range(0, t.shape[0], chunk))


def phase_kstep_big() -> None:
    """A K = 8 CUDA graph captured on a rows state larger than half the
    card's free memory (FM order 2, k 8, a row accumulator; 8 batches of
    4,096 x 39 ids, half of each row's ids in a hot 2^16-id head): the
    capture's and replay's peak allocation above the live state under the
    step's temporaries (bounded by 2 GiB, against the state's tens of GiB a
    scratch copy would take); the rows outside the batches' ids unchanged
    (their bit sums); the graphed K steps bitwise the plain loop run from
    the same state (the touched rows put back first)."""
    import torch

    from fast_tffm_tpu_torch.models import Batch, FMModel
    from fast_tffm_tpu_torch.trainer import (
        TrainState,
        k_step_loop,
        make_scanned_train_step,
        train_step_body,
    )

    t0 = time.perf_counter()
    k, b, n, d = 8, 4096, 39, 9
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    vocab = int(0.55 * free) // ((d + 1) * 4)
    model = FMModel(vocabulary_size=vocab, factor_num=d - 1, order=2)
    g = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.empty((vocab, d), device=dev)
    for lo in range(0, vocab, 1 << 24):
        table[lo:lo + (1 << 24)].uniform_(-0.01, 0.01, generator=g)
    state = TrainState(table=table, dense=[], step=0,
                       table_accum=torch.full((vocab, 1), 0.1, device=dev))
    state_bytes = vocab * (d + 1) * 4
    ids = torch.randint(0, vocab, (k, b, n), generator=g, device=dev, dtype=torch.int64)
    ids[..., : n // 2] %= 1 << 16
    fields = (
        (torch.rand((k, b), generator=g, device=dev) < 0.3).float(), ids.to(torch.int32),
        torch.rand((k, b, n), generator=g, device=dev) + 0.1,
        torch.zeros((k, b, 0), dtype=torch.int32, device=dev), torch.ones((k, b), device=dev),
    )
    touched = torch.unique(ids)
    del ids
    before = (state.table[touched].clone(), state.table_accum[touched].clone())
    rest = (_bits_sum(state.table) - _bits_sum(before[0]),
            _bits_sum(state.table_accum) - _bits_sum(before[1]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    step = make_scanned_train_step(model, 0.05, body=train_step_body)
    state, graphed = step(state, Batch(*fields))
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - base
    after = (state.table[touched].clone(), state.table_accum[touched].clone())
    untouched = (_bits_sum(state.table) - _bits_sum(after[0]),
                 _bits_sum(state.table_accum) - _bits_sum(after[1])) == rest
    state.table[touched], state.table_accum[touched] = before
    plain = k_step_loop(model, 0.05, train_step_body, lambda i, *f: Batch(*(x[i] for x in f)))
    _, plain_losses = plain(TrainState(table=state.table, dense=[], step=0,
                                       table_accum=state.table_accum), *fields)
    torch.cuda.synchronize()
    bitwise = (torch.equal(graphed, plain_losses) and torch.equal(state.table[touched], after[0])
               and torch.equal(state.table_accum[touched], after[1]))
    rec = {"phase": "kstep_big", "vocab_rows": vocab, "state_gib": state_bytes / 2**30,
           "free_gib_before": free / 2**30, "peak_over_state_gib": extra / 2**30,
           "touched_rows": int(touched.numel()), "captures": step.graphs.captures,
           "replays": step.graphs.replays, "untouched_rows_unchanged": untouched,
           "bitwise_plain_loop": bitwise, "seconds": time.perf_counter() - t0}
    del state, table, before, after, fields, step, plain
    torch.cuda.empty_cache()
    if not (untouched and bitwise and rec["captures"] == 1 and state_bytes > free / 2
            and extra < min(2 << 30, state_bytes // 4)):
        fail(f"kstep_big: {rec}")
    emit(rec)


def phase_zipf_tails(rung: int) -> dict:
    """B4 and B3 against their plain twins at the drivers' Zipf shapes, B
    65,536 x 39 Zipf(1.1) ids (bench_torch.zipf_ids; id 0 ~9.5% of them):
    B4 at the packed address with an element accumulator on a 2^24 x 9
    table (the headline's), bitwise its twin; B3 on the fused array of
    ``rung`` rows (bench_torch.fused_scale_state, the scale rung's), the
    twin on a compacted copy of the touched tile rows with the ids remapped
    in order (the same sums in the same order), bitwise, and the rest of the
    array unchanged (its bit patterns' sum before and after).  Times: the kernel
    on the sort's output (events; device time L2-warm and flushed), the
    update (sort + kernel), the twin; the bytes and sector bounds."""
    import numpy as np
    import torch

    from bench_torch import fused_scale_state, zipf_ids
    from fast_tffm_tpu_torch.ops.packed_table import (
        LANES,
        fused_rows_per_tile,
        pack_accum_any,
        pack_table,
    )
    from fast_tffm_tpu_torch.ops.tail import (
        fused_tail_adagrad_update,
        fused_tail_sorted,
        fused_tail_sorted_plain,
        rows_tail_adagrad_update,
        rows_tail_sorted,
        rows_tail_sorted_plain,
    )

    d, lr = 9, 0.01
    rng = np.random.default_rng(SEED + 19)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    out = {}

    def batch(vocab):
        ids = torch.from_numpy(zipf_ids(rng, (ZIPF_BATCH, ZIPF_NNZ), vocab)).cuda()
        grads = torch.randn((ZIPF_BATCH * ZIPF_NNZ, d), generator=gen, device="cuda") * 1e-3
        sid, order = torch.sort(ids.reshape(-1), stable=True)
        return ids, grads, sid, order

    # B4, packed address, element accumulator, 2^24 rows.
    v = ZIPF_PACKED_VOCAB
    ids, grads, sid, order = batch(v)
    logical = torch.empty((v, d), device="cuda").uniform_(-0.01, 0.01, generator=gen)
    accum = torch.empty((v, d), device="cuda").uniform_(0.1, 0.5, generator=gen)
    t_p, a_p = pack_table(logical), pack_accum_any(accum, d, 0.1)
    del logical, accum
    t_k, a_k = t_p.clone(), a_p.clone()
    rows_tail_sorted(t_k, a_k, sid, order, grads, lr, packed=True)
    rows_tail_sorted_plain(t_p, a_p, sid, order, grads, lr, packed=True)
    torch.cuda.synchronize()
    if not (torch.equal(t_k, t_p) and torch.equal(a_k, a_p)):
        fail("zipf_tail: B4 at the packed address is not bitwise its plain version at "
             f"B {ZIPF_BATCH} x {ZIPF_NNZ} Zipf ids on {v} rows")
    m, k = int(sid.numel()), int(torch.unique(sid).numel())
    rec = {"phase": "zipf_tail", "kernel": "rows_tail_adagrad", "layout": "packed",
           "accumulator": "element", "V": v, "D": d, "N": ZIPF_NNZ, "M": m, "K": k,
           "hot_id_occurrences": int((sid == 0).sum()), "bitwise": True, "max_abs_err": 0.0}
    rec.update(_zipf_timings(
        "rows_element_kernel",
        kernel=lambda: rows_tail_sorted(t_k, a_k, sid, order, grads, lr, packed=True),
        update=lambda: rows_tail_adagrad_update(t_k, a_k, ids, grads, lr, packed=True),
        plain=lambda: rows_tail_sorted_plain(t_p, a_p, sid, order, grads, lr, packed=True)))
    rec["bound_ms"], rec["bound_by"] = tail_bound(m, k, d, d)
    rec["sector_bound_ms"] = tail_sector_bound(m, k, d, d, fused=False)
    emit(rec)
    out["rows_tail_adagrad"] = rec
    del t_k, a_k, t_p, a_p, ids, grads, sid, order
    torch.cuda.empty_cache()

    # B3 on the scale rung's fused array: the largest that fits, from ``rung`` down.
    from bench_torch import SCALE_VOCABS

    fallbacks = []
    for cand in [rung] + [x for x in SCALE_VOCABS if x < rung]:
        try:
            fused = fused_scale_state(cand, d - 1, torch.device("cuda")).table
            ids, grads, sid, order = batch(cand)
            break
        except torch.cuda.OutOfMemoryError as e:
            fallbacks.append(f"vocab={cand}: out of memory: {str(e).splitlines()[0][:80]}")
        fused = ids = grads = sid = order = None
        torch.cuda.empty_cache()
    else:
        fail("zipf_tail: no fused rung fits the card")
    p = fused_rows_per_tile(d)
    phys = sid.long() // p
    uphys, inv = torch.unique_consecutive(phys, return_inverse=True)
    compact = fused[uphys].clone()  # the touched tile rows, in order
    cid = (inv * p + sid.long() % p).to(torch.int32)  # the ids there, still sorted
    untouched = _bits_sum(fused) - _bits_sum(compact)  # the rest of the array, before
    fused_tail_sorted(fused, sid, order, grads, lr)
    fused_tail_sorted_plain(compact, cid, order, grads, lr)
    torch.cuda.synchronize()
    if not torch.equal(fused[uphys], compact):
        fail(f"zipf_tail: B3 is not bitwise its plain version at B {ZIPF_BATCH} x {ZIPF_NNZ} "
             f"Zipf ids on the {cand}-row fused array")
    if _bits_sum(fused) - _bits_sum(fused[uphys]) != untouched:
        fail(f"zipf_tail: B3 wrote outside the touched tile rows of the {cand}-row fused array")
    m, k = int(sid.numel()), int(torch.unique(sid).numel())
    rec = {"phase": "zipf_tail", "kernel": "fused_tail_adagrad", "layout": "fused",
           "V": cand, "fused_rows": int(fused.shape[0]), "lanes": LANES,
           "fused_gib": fused.numel() * 4 / 2**30, "rung_fallbacks": fallbacks,
           "D": d, "N": ZIPF_NNZ, "M": m, "K": k, "touched_tile_rows": int(uphys.numel()),
           "hot_id_occurrences": int((sid == 0).sum()), "bitwise": True, "max_abs_err": 0.0,
           "untouched_rows_unchanged": True}
    rec.update(_zipf_timings(
        "fused_slot_kernel",
        kernel=lambda: fused_tail_sorted(fused, sid, order, grads, lr),
        update=lambda: fused_tail_adagrad_update(fused, ids, grads, lr),
        plain=lambda: fused_tail_sorted_plain(compact, cid, order, grads, lr)))
    rec["bound_ms"], rec["bound_by"] = tail_bound(m, k, d, 1)
    rec["sector_bound_ms"] = tail_sector_bound(m, k, d, 1, fused=True)
    emit(rec)
    out["fused_tail_adagrad"] = rec
    del fused, compact, ids, grads, sid, order
    torch.cuda.empty_cache()
    return out


BENCH_ALL_ARGS = ["bench_all_torch.py", "--out", os.path.join(DRIVERS_OUT, "bench_all_torch.json")]


def phase_bench_all(started=None) -> dict:
    """bench_all_torch.py from the checkout (default: the 600k-row held-out
    slice; ``started``: already running, in the whole script beside the
    dist and quality phases): exit 0, no FAILED row and no ``*_error`` key,
    the fit line's AUC >= FIT_AUC_MIN."""
    path = BENCH_ALL_ARGS[-1]
    rc, _, seconds = _driver("bench_all_torch", BENCH_ALL_ARGS, 900, started=started)
    with open(path) as f:
        art = json.load(f)
    # A FAILED row, or a row with any ``*_error`` key (a knee run at B 32,768
    # or 65,536 that raised keeps its row's default-batch value).
    failed = [r["metric"] for r in art["results"]
              if r["value"] is None or any(k.endswith("_error") for k in r)]
    if rc != 0 or failed:
        fail(f"bench_all_torch.py exited {rc}, failed rows {failed}")
    fit = [r for r in art["results"] if r["metric"].startswith("convergence fit")]
    if not fit or fit[0]["value"] < FIT_AUC_MIN:
        fail(f"bench_all_torch.py: the fit line's AUC {fit and fit[0]['value']} < {FIT_AUC_MIN}")
    emit({"phase": "bench_all", "seconds": seconds, "card": art.get("card"),
          "beside_dist_phases": started is not None,
          "rows": {r["metric"].split(":")[0] + (" @" + str(r["knee_batch"]) if "knee_batch" in r
                                                 else ""): [r["value"], r.get("knee_value")]
                   for r in art["results"]},
          "fit_auc": fit[0]["value"], "fit_auc_min": FIT_AUC_MIN,
          "kernel_launches": art["kernel_launches"]})
    return art


def _serve_summary(r: dict) -> dict:
    ms = r.get("client_ms", {})
    return {k: r.get(k) for k in ("mode", "transport", "wire", "qps_target", "qps_achieved",
                                  "requests_sent", "requests_scored", "unanswered",
                                  "shed_codes", "steady_state_recompiles")} | {
        "p50_ms": ms.get("p50"), "p99_ms": ms.get("p99")}


def phase_loadgen(tmp: str, beside: str | None = None) -> dict:
    """tools/torch_loadgen.py on baseline5 at full width (order 3, 2^20 x 9,
    max_nnz 11; a fresh seeded checkpoint, --init-missing-checkpoint):
    closed loop in process (the saturation rate), open loop in process at
    25%, 50% and 75% of it; a tier of 2 replicas spawned once and driven
    through --connect: its closed loop, a JSONL open loop at JSONL_QPS (or
    half its closed rate), --stats; a --spawn run over binary frames at half
    the tier's closed rate; --probe-freshness 3.  Fails on an unanswered request, on any error
    below saturation (the open loops) and on a steady-state recompile.
    Writes every run's BENCH_SERVE object to DRIVERS_OUT/BENCH_SERVE_TORCH.json.
    ``beside``: the main thread's phases it ran beside, if any (recorded;
    its rates are then not the record)."""
    from fast_tffm_tpu_torch.serving.client import spawn_serve
    from fast_tffm_tpu_torch.telemetry import device_stamp, write_json_artifact

    ckpt = os.path.join(tmp, "loadgen.ckpt")
    # No predict_files: loadgen synthesizes mixed-width request lines.
    cfg_path = _write_ini(os.path.join(tmp, "loadgen.cfg"), General={"model_file": ckpt},
                          Predict={"predict_files": ""},
                          Serving={"replicas": 2, "reload_interval_s": 0.2})
    base = ["tools/torch_loadgen.py", cfg_path, "--device", "cuda"]
    runs: dict = {}

    def run(name: str, extra: list, *, open_loop: bool, socket: bool) -> dict:
        path = os.path.join(DRIVERS_OUT, f"loadgen_{name}.json")
        rc, _, seconds = _driver(f"loadgen_{name}", base + extra + ["--out", path], 300)
        if rc != 0:
            fail(f"loadgen {name}: exited {rc}")
        with open(path) as f:
            r = json.load(f)
        r["command_s"] = seconds
        if r.get("steady_state_recompiles") != 0:
            fail(f"loadgen {name}: steady_state_recompiles {r.get('steady_state_recompiles')}")
        if socket and r.get("unanswered", 0 if r["mode"] == "closed" else None) != 0:
            fail(f"loadgen {name}: {r.get('unanswered')} requests unanswered")
        # Every request sent was scored or shed with a code: in process (no
        # ``unanswered`` key) a future still open after the drain is lost here.
        lost = r["requests_sent"] - r["requests_scored"] - sum(r["shed_codes"].values())
        if lost:
            fail(f"loadgen {name}: {lost} of {r['requests_sent']} requests neither scored "
                 "nor shed")
        if open_loop and r.get("shed_codes"):
            fail(f"loadgen {name}: errors below saturation {r['shed_codes']}")
        runs[name] = r
        return r

    traffic = ["--duration", str(LOADGEN_S)]
    sat = run("inprocess_closed", ["--mode", "closed", "--concurrency", str(CLOSED_INPROCESS),
                                   *traffic,
                                   "--init-missing-checkpoint"],
              open_loop=False, socket=False)["qps_achieved"]
    for pct in (25, 50, 75):
        run(f"inprocess_open_{pct}", ["--mode", "open", "--qps", f"{sat * pct / 100:.1f}",
                                      *traffic], open_loop=True, socket=False)
    proc, port = spawn_serve(cfg_path, device="cuda", timeout_s=240, log=log_stderr)
    try:
        at = ["--connect", f"127.0.0.1:{port}"]
        ssat = run("socket_closed", [*at, "--mode", "closed", "--concurrency",
                                     str(CLOSED_SOCKET), *traffic],
                   open_loop=False, socket=True)["qps_achieved"]
        run("socket_jsonl_open", [*at, "--wire", "jsonl", "--connections", "2",
                                  "--qps", f"{min(JSONL_QPS, ssat / 2):.1f}", *traffic],
            open_loop=True, socket=True)
        rc, out, _ = _driver("loadgen_stats", base + [*at, "--stats"], 120)
        if rc != 0:
            fail(f"loadgen --stats exited {rc}")
        stats = _last_json(out, "loadgen --stats")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
    run("socket_binary_open", ["--spawn", "--wire", "binary", "--connections", "2",
                               "--frame-rows", "32", "--qps", f"{ssat / 2:.1f}", *traffic],
        open_loop=True, socket=True)
    fresh = os.path.join(DRIVERS_OUT, "loadgen_freshness.json")
    rc, _, seconds = _driver("loadgen_freshness", base + ["--spawn", "--probe-freshness", "3",
                                                          "--out", fresh], 300)
    with open(fresh) as f:
        probe = json.load(f)
    if rc != 0 or probe.get("unanswered") != 0 or probe.get("steady_state_recompiles") != 0:
        fail(f"loadgen --probe-freshness: exited {rc}, unanswered {probe.get('unanswered')}, "
             f"steady_state_recompiles {probe.get('steady_state_recompiles')}")
    replica_launches = {r: (e.get("launches") or {}).get("anova_fwd")
                        for r, e in sorted(stats.get("engines", {}).items())}
    from fast_tffm_tpu_torch.config import load_config

    cfg = load_config(cfg_path)
    sweep = {
        "bench": "BENCH_SERVE_SWEEP",
        "generated_by": "chip_smoke.py phase loadgen (tools/torch_loadgen.py runs)",
        **device_stamp("cuda"),
        "config": f"{CONFIG} (order {cfg.order}, {cfg.vocabulary_size} x {1 + cfg.factor_num}, "
                  f"max_nnz {cfg.max_nnz}; replicas 2, reload_interval_s 0.2)",
        "seconds_per_run": LOADGEN_S,
        "saturation_qps_inprocess": sat,
        "saturation_qps_socket_closed": ssat,
        "runs": runs,
        "stats": stats,
        "freshness": probe,
    }
    write_json_artifact(os.path.join(DRIVERS_OUT, "BENCH_SERVE_TORCH.json"), sweep,
                        sort_keys=False)
    emit({"phase": "loadgen", "beside": beside,
          "saturation_qps_inprocess": sat,
          "saturation_qps_socket_closed": ssat,
          "runs": {n: _serve_summary(r) | {"command_s": r["command_s"]} for n, r in runs.items()},
          "freshness_ms": probe.get("publish_to_first_scored_ms"),
          "freshness_seconds": seconds, "stats_replicas": len(stats.get("replicas", [])),
          "replica_anova_launches": replica_launches})
    launches = {f"loadgen_{n}": r["kernel_launches"]["anova_fwd"]
                for n, r in runs.items() if r.get("kernel_launches")}
    for n, r in runs.items():
        for rep, e in (r.get("engines") or {}).items():
            launches[f"loadgen_{n}_r{rep}"] = (e.get("launches") or {}).get("anova_fwd")
    launches.update({f"loadgen_tier_r{r}": n for r, n in replica_launches.items()})
    return launches


def phase_bench_legs() -> tuple[dict, dict]:
    """bench, kstep_big and zipf_tail, in that order: (bench's line, the
    Zipf holds)."""
    import torch

    torch.cuda.empty_cache()
    bench = phase_bench()
    phase_kstep_big()
    return bench, phase_zipf_tails(bench["scale_vocab_rows"])


def phase_drivers(tmp: str, bench_legs=None, bench_all=None, serve=None) -> dict:
    """The three drivers and the Zipf-shape holds, then loadgen alone;
    returns each kernel's launches by driver run.  ``bench_legs``,
    ``bench_all`` and ``serve``: phase_bench_legs()'s, phase_bench_all()'s
    and phase_loadgen()'s results when they already ran (the whole script,
    whose 1200 s bound they would otherwise crowd, runs the bench legs
    beside the tools phase, bench_all_torch.py beside the dist and quality
    phases and loadgen beside the telemetry_train .. tiered_big phases: none
    gates on a time, and their numbers are then not the record; ``--only
    drivers`` runs each alone and makes the committed artifacts)."""
    bench, zipf = bench_legs or phase_bench_legs()
    if bench_all is None:
        bench_all = phase_bench_all()
    if serve is None:
        serve = phase_loadgen(tmp)
    by_kernel = {k: {} for k in KERNELS}
    for run, counts in (("bench_torch", bench["kernel_launches"]),
                        ("bench_all_torch", bench_all["kernel_launches"])):
        for k in KERNELS:
            if counts.get(k):
                by_kernel[k][run] = counts[k]
    by_kernel["anova_fwd"].update({r: n for r, n in serve.items() if n})
    return {"launches": by_kernel, "zipf": zipf}


def _tool_artifact(what: str, started, out: str, timeout: float) -> tuple[int, dict, float]:
    """A started tool to its end (its output under TOOLS_OUT); (returncode,
    its JSON artifact, seconds)."""
    rc, _, seconds = _driver(what, [], timeout, started=started, out_dir=TOOLS_OUT)
    if not os.path.exists(out):
        fail(f"{what}: exited {rc} and wrote no artifact (chiprun_out/tools/{what}.err)")
    with open(out) as f:
        return rc, json.load(f), seconds


def _chaos_reference(tmp: str) -> dict:
    """Chaos's train config (tools/torch_chaos.py's dataset and config) as
    its baseline child runs it, `cli train --device cuda`, then in process
    on the card (bitwise the child's final checkpoint; the wrappers count B4
    and the order-2 pair once per step, validation's forwards besides, and
    nothing else) and on the CPU from the card run's
    initial state (within TABLE_ATOL of the card's)."""
    import dataclasses

    import numpy as np
    import torch

    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
    from fast_tffm_tpu_torch.config import build_model, load_config
    from fast_tffm_tpu_torch.trainer import init_state
    from tools import torch_chaos

    cfgs = {}
    for name in ("child", "card", "cpu"):
        d = os.path.join(tmp, f"chaos_{name}")
        os.makedirs(d, exist_ok=True)
        torch_chaos._write_dataset(os.path.join(d, "t.libsvm"))
        cfgs[name] = torch_chaos._write_cfg(d)
    r = _cli(["train", cfgs["child"], "--device", "cuda"])
    if r.returncode != 0:
        fail(f"tools: chaos's baseline child exited {r.returncode}: {r.stderr[-2000:]}")
    card_cfg = load_config(cfgs["card"])
    _zero_counters()
    _train_once(card_cfg, "cuda", [], resume=False)
    launches = _wrapper_counts()
    want = dict.fromkeys(("rows_tail_adagrad", "fm2_fwd", "fm2_bwd"), torch_chaos.STEPS)
    if not _launches_match(launches, want):
        fail(f"tools: chaos reference launches {launches}, want {want} (forwards at least)")
    width = card_cfg.factor_num + 1
    final = {n: restore_checkpoint(load_config(c).model_file, torch.device("cpu"),
                                   accum_width=width) for n, c in cfgs.items() if n != "cpu"}
    bitwise = all(torch.equal(getattr(final["child"], k), getattr(final["card"], k))
                  for k in ("table", "table_accum")) and final["child"].step == final["card"].step
    if not bitwise:
        fail("tools: chaos's train config in process is not bitwise its CLI child")
    # The CPU from the card's initial state (training's own init: the card's
    # generator, seed 0), saved as its starting checkpoint.
    cpu_cfg = load_config(cfgs["cpu"])
    init = init_state(build_model(cpu_cfg), torch.Generator(device="cuda").manual_seed(0),
                      cpu_cfg.init_accumulator_value, cpu_cfg.adagrad_accumulator)
    save_checkpoint(cpu_cfg.model_file, dataclasses.replace(
        init, table=init.table.cpu(), table_accum=init.table_accum.cpu()))
    cpu, _ = _train_once(cpu_cfg, "cpu", [], resume=True)
    diffs = {k: float(np.abs(getattr(final["card"], k).numpy() - getattr(cpu, k).numpy()).max())
             for k in ("table", "table_accum")}
    if cpu.step != final["card"].step or max(diffs.values()) > TABLE_ATOL:
        fail(f"tools: chaos's train config on the card against the CPU: step "
             f"{final['card'].step} / {cpu.step}, max abs diffs {diffs} > {TABLE_ATOL}")
    return {"bitwise_cli_child": bitwise, "launches": launches,
            "max_abs_table_diff": diffs["table"], "max_abs_accum_diff": diffs["table_accum"]}


def phase_tools(tmp: str, beside=None) -> dict:
    """The chaos, soak and beyond-HBM tools on the card as a user runs them,
    all four at once, and chaos's train config in process meanwhile, then
    ``beside()`` while they run (the whole script: phase_bench_legs; see
    the module docstring).  Returns B4's launches by run (chaos_reference,
    probe_tier) under ``launches`` and ``beside()``'s result under
    ``beside``."""
    t0 = time.perf_counter()
    out = {k: os.path.join(TOOLS_OUT, f"{k}.json")
           for k in ("PROBE_MTTR_TORCH", "PROBE_TIER_TORCH", "PROBE_SERVE_CHAOS_TORCH",
                     "PROBE_SOAK_TORCH_smoke")}
    for path in out.values():
        if os.path.exists(path):
            os.remove(path)  # an artifact read below is this run's
    chaos = _start_driver(["tools/torch_chaos.py", "--trials", "1", "--sharded", "--device",
                           "cuda", "--out", out["PROBE_MTTR_TORCH"]])
    probe = _start_driver(["tools/torch_probe_tier.py", "--vocab", str(TOOLS_PROBE_VOCAB),
                           "--steps", str(TOOLS_PROBE_STEPS), "--device", "cuda",
                           "--out", out["PROBE_TIER_TORCH"]])
    serve = _start_driver(["tools/torch_chaos.py", "--serve", "--device", "cuda",
                           "--out", out["PROBE_SERVE_CHAOS_TORCH"]])
    soak = _start_driver(["tools/torch_soak.py", "--smoke", "--minutes", "0.3",
                          "--device", "cuda", "--out", out["PROBE_SOAK_TORCH_smoke"]])
    reference = _chaos_reference(tmp)
    beside_result = beside() if beside is not None else None
    rc, mttr, chaos_s = _tool_artifact("torch_chaos", chaos, out["PROBE_MTTR_TORCH"], 600)
    trials = {m: p["trials"] for m, p in mttr["paths"].items()}
    if rc != 0 or set(trials) != {"train", "dist_train"} or not all(
            p["all_losses_bit_identical"] for p in mttr["paths"].values()) or not all(
            t["crashes"] == 1 and t["restarts"] == 1 and t["mttr_s"] and t["mttr_s"][0] is not None
            for ts in trials.values() for t in ts):
        fail(f"tools: torch_chaos.py exited {rc}: {json.dumps(mttr['paths'])[:2000]}")
    rc, tier, probe_s = _tool_artifact("torch_probe_tier", probe, out["PROBE_TIER_TORCH"], 600)
    b4 = tier.get("kernel_launches", {}).get("rows_tail_adagrad", 0)
    if (rc != 0 or tier["hit_rate_gap"] > 0.02 or tier["steady_state_recompiles"] != 0
            or not b4 or tier["resident_state_bytes_this_vocab"] <= tier["device_memory_bytes"]):
        fail(f"tools: torch_probe_tier.py exited {rc}: hit_rate_gap {tier['hit_rate_gap']}, "
             f"steady recompiles {tier['steady_state_recompiles']}, B4 launches {b4}, resident "
             f"{tier['resident_state_bytes_this_vocab']} against the card's "
             f"{tier['device_memory_bytes']}")
    rc, sc, serve_s = _tool_artifact("torch_chaos_serve", serve, out["PROBE_SERVE_CHAOS_TORCH"],
                                     600)
    if rc != 0 or not sc.get("ok") or sc["unanswered"] != 0 or sc["scores_mismatched"] != 0 or (
            sc["replica_restarts"] < 1) or not any(
            (v or 0) >= 1 for v in sc["reload_failures_by_replica"].values()):
        fail(f"tools: torch_chaos.py --serve exited {rc}: "
             f"{json.dumps({k: v for k, v in sc.items() if k != 'plan'})[:2000]}")
    rc, sk, soak_s = _tool_artifact("torch_soak", soak, out["PROBE_SOAK_TORCH_smoke"], 600)
    # The gate, and tests/test_soak.py's checks of it: traffic answered in
    # full, the trainer killed and back, the writer stalled, the ticks ran.
    if rc != 0 or sk.get("gate") != "OK" or not (
            0 < sk["requests_sent"] == sk["requests_answered"] and sk["unanswered"] == 0
            and sk["trainer_restarts"] >= 1 and sk["stream_stalls_executed"] >= 1
            and sk["trainer_rc"] == 0 and sk["trainer_steady_compiles"] == 0
            and sk["sentinel_ticks"] >= 2 and sk["sentinel_failures"] == 0
            and 0 <= sk["max_chain_len"] <= 16):
        fail(f"tools: torch_soak.py --smoke exited {rc}: "
             f"{json.dumps({k: v for k, v in sk.items() if k != 'ticks'})[:2000]}")
    emit({"phase": "tools", "seconds": time.perf_counter() - t0, "card": mttr.get("card"),
          "chaos": {"seconds": chaos_s, "paths": {
              m: {k: p[k] for k in ("baseline_wall_s", "mttr_s_median", "mttr_s_max",
                                     "all_losses_bit_identical")} | {
                  "kill_at_step": [t["kill_at_step"] for t in p["trials"]]}
              for m, p in mttr["paths"].items()}},
          "chaos_reference": reference,
          "probe_tier": {"seconds": probe_s, **{k: tier[k] for k in (
              "hit_rate_measured", "hit_rate_predicted_exact", "hit_rate_gap",
              "coverage_curve_exact", "dedup_ratio_mean", "miss_bytes_per_step",
              "wire_bytes_per_step", "resident_state_bytes_this_vocab", "device_memory_bytes",
              "steady_state_recompiles", "kernel_launches", "workload")}},
          "serve_chaos": {"seconds": serve_s, **{k: sc.get(k) for k in (
              "unanswered", "scores_mismatched", "scored", "replica_restarts", "mttr_s",
              "client_failovers", "reload_failures_by_replica", "steady_compiles_by_replica",
              "all_healthy_after")}},
          "soak_smoke": {"seconds": soak_s, **{k: sk.get(k) for k in (
              "gate", "duration_s", "requests_sent", "unanswered", "trainer_restarts",
              "stream_stalls_executed", "max_chain_len", "client_latency_ms",
              "freshness_final", "sentinel_ticks")}}})
    return {"launches": {"chaos_reference": reference["launches"]["rows_tail_adagrad"],
                         "probe_tier": b4},
            "beside": beside_result}


# The quality tools: the study's one point, and the in-process
# hold's order-3 FM on the zoo's --quick data (fm3: 12 fields, seeds 20/21).
QUALITY_STUDY_ROWS, QUALITY_STUDY_ORACLE = 200_000, 0.91053
QUALITY_HOLD_ROWS, QUALITY_HOLD_TEST_ROWS, QUALITY_HOLD_EPOCHS = 60_000, 8_000, 2
QUALITY_ORACLE_SLACK = 0.01  # a held-out AUC above its oracle by more is a fault


def _quality_hold(tmp: str) -> dict:
    """tools/torch_quality_zoo.py's fm3 config (order 3, its --quick data)
    through training.train in process, on the card and then on the CPU from
    one seeded npz: the validation AUCs of every epoch within AUC_TOL, the
    trained tables within TABLE_ATOL, and B1, B2 and B4 launched in each
    step of the card run."""
    import numpy as np
    import torch

    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
    from fast_tffm_tpu_torch.config import build_model
    from tools import torch_quality_zoo as zoo

    d = os.path.join(tmp, "quality_fm3")
    os.makedirs(d, exist_ok=True)
    tr, _, _ = zoo._gen_split(d, "fm3_tr", zoo.planted_fm3_score, 12, QUALITY_HOLD_ROWS, 20,
                              "libsvm")
    te, _, _ = zoo._gen_split(d, "fm3_te", zoo.planted_fm3_score, 12, QUALITY_HOLD_TEST_ROWS,
                              21, "libsvm")
    base = zoo.train_config(d, "fm3", tr, te, model="fm", fields=0, epochs=QUALITY_HOLD_EPOCHS,
                            order=3, lr=0.25)
    model = build_model(base)
    table, _, init = _seeded_init(np.random.default_rng(SEED + 19), d, "quality_fm3", base,
                                  model, False)
    aucs, states, seconds = {}, {}, {}
    for device in ("cuda", "cpu"):
        cfg = _phase_cfg(base, d, "quality_fm3", device, init,
                         metrics_path=os.path.join(d, f"jl_fm3.{device}.jsonl"))
        if device == "cuda":
            _zero_counters()
        _, seconds[device] = _train_once(cfg, device, [])
        if device == "cuda":
            launches = _wrapper_counts()
        with open(cfg.metrics_path) as f:
            aucs[device] = [r["validation_auc"] for r in map(json.loads, f)
                            if "validation_auc" in r]
        states[device] = restore_checkpoint(cfg.model_file, torch.device("cpu"),
                                            accum_width=model.row_dim)
    steps = states["cuda"].step
    _expect_steps("quality: the zoo's fm3 config", launches, steps)
    diff = max((abs(a - b) for a, b in zip(aucs["cuda"], aucs["cpu"])), default=float("inf"))
    table_diff = float(np.abs(states["cuda"].table.numpy() - states["cpu"].table.numpy()).max())
    if len(aucs["cuda"]) != QUALITY_HOLD_EPOCHS or len(aucs["cpu"]) != len(aucs["cuda"]) or (
            diff > AUC_TOL) or states["cpu"].step != steps or not table_diff <= TABLE_ATOL:
        fail(f"quality: the zoo's fm3 config, validation AUCs card {aucs['cuda']} against CPU "
             f"{aucs['cpu']} (within {AUC_TOL}), steps {steps} / {states['cpu'].step}, "
             f"max abs table diff {table_diff} (within {TABLE_ATOL})")
    return {"steps": steps, "launches": launches, "validation_auc": aucs,
            "max_abs_auc_diff": diff, "seconds": seconds, "max_abs_table_diff": table_diff,
            "max_abs_table_update": float(np.abs(states["cuda"].table.numpy() - table).max())}


def _held_out_ok(auc: float, oracle: float) -> bool:
    return 0.5 < auc <= oracle + QUALITY_ORACLE_SLACK


def phase_quality(tmp: str, beside=None) -> dict:
    """The quality tools on the card as a user runs them, all three at once
    (torch_quality_zoo.py --quick, torch_backtest.py --quick,
    torch_scaling_study.py at one small point and one epoch), the zoo's fm3
    config in process meanwhile (``_quality_hold``), then ``beside()`` while
    they run (the whole script: phase_dist_b2).  Gates: every tool exits 0;
    every held-out AUC above 0.5 and at most its oracle + 0.01; the study's
    oracle the JAX artifact's; the backtest's gate OK; B4 in every
    artifact's kernel_launches, B1 and B2 too in the zoo's.  Returns each
    kernel's launches by run under ``launches`` and ``beside()``'s result
    under ``beside``."""
    t0 = time.perf_counter()
    out = {k: os.path.join(TOOLS_OUT, f"{k}.json")
           for k in ("QUALITY_ZOO_TORCH_quick", "BACKTEST_TORCH_quick", "SCALING_STUDY_TORCH_point")}
    for path in out.values():
        if os.path.exists(path):
            os.remove(path)  # an artifact read below is this run's
    zoo = _start_driver(["tools/torch_quality_zoo.py", "--quick", "--device", "cuda",
                         "--out", out["QUALITY_ZOO_TORCH_quick"]])
    backtest = _start_driver(["tools/torch_backtest.py", "--quick", "--device", "cuda",
                              "--out", out["BACKTEST_TORCH_quick"]])
    study = _start_driver(["tools/torch_scaling_study.py", "--rows", str(QUALITY_STUDY_ROWS),
                           "--epochs", "1", "--device", "cuda",
                           "--out", out["SCALING_STUDY_TORCH_point"]])
    hold = _quality_hold(tmp)
    hold_s = time.perf_counter() - t0
    beside_result = beside() if beside is not None else None
    rc, z, zoo_s = _tool_artifact("torch_quality_zoo", zoo, out["QUALITY_ZOO_TORCH_quick"], 600)
    fams = z["families"]
    aucs = {f"{k}{suffix}": (r[key], r["oracle_auc"]) for k, r in fams.items()
            for key, suffix in (("heldout_auc", ""), ("fm_baseline_auc", "_fm_baseline"))
            if key in r}
    kl = z["kernel_launches"]
    if rc != 0 or set(fams) != {"ffm", "fm3", "deepfm"} or not all(
            _held_out_ok(*v) for v in aucs.values()) or not (
            kl["rows_tail_adagrad"] and kl["anova_fwd"] and kl["anova_bwd"]):
        fail(f"quality: torch_quality_zoo.py --quick exited {rc}: {json.dumps(z)[:2000]}")
    rc, bt, bt_s = _tool_artifact("torch_backtest", backtest, out["BACKTEST_TORCH_quick"], 600)
    if rc != 0 or bt["gate"] != "OK" or not bt["kernel_launches"]["rows_tail_adagrad"]:
        fail(f"quality: torch_backtest.py --quick exited {rc}: {json.dumps(bt)[:2000]}")
    rc, ss, ss_s = _tool_artifact("torch_scaling_study", study, out["SCALING_STUDY_TORCH_point"],
                                  600)
    (point,) = ss["points"]
    if rc != 0 or point["oracle_auc"] != QUALITY_STUDY_ORACLE or not _held_out_ok(
            point["heldout_auc"], point["oracle_auc"]) or not ss["kernel_launches"][
            "rows_tail_adagrad"]:
        fail(f"quality: torch_scaling_study.py exited {rc}: {json.dumps(ss)[:2000]}")
    emit({"phase": "quality", "seconds": time.perf_counter() - t0, "hold_seconds": hold_s,
          "card": z["card"], "fm3_hold": hold,
          "zoo": {"seconds": zoo_s, "families": fams, "kernel_launches": kl},
          "backtest": {"seconds": bt_s, **{k: bt[k] for k in (
              "gate", "auc_by_hour", "auc_online_mean", "auc_batch_mean", "worst_hour_gap",
              "kernel_launches")}},
          "scaling_study": {"seconds": ss_s, "point": point,
                            "kernel_launches": ss["kernel_launches"]}})
    by_run = {"quality_fm3": hold["launches"], "quality_zoo": kl,
              "quality_backtest": bt["kernel_launches"], "quality_study": ss["kernel_launches"]}
    return {"launches": {k: {run: c[k] for run, c in by_run.items() if c[k]} for k in KERNELS},
            "beside": beside_result}


def _kernel_record(name, source, replaces, launches, worst, main, launches_by_run,
                   shapes=None, packed=None) -> dict:
    rec = {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "launches_by_run": launches_by_run,
        "max_abs_err": worst,
        "ms": main["ms"],
        "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the same function
    }
    if shapes:
        rec["shapes"] = {
            label: {k: r[k] for k in ("D", "N", "M", "K", "ms", "device_ms", "device_ms_flushed",
                                      "update_ms", "plain_ms", "bound_ms", "bound_by",
                                      "sector_bound_ms")}
            for label, r in shapes.items()
        }
    if packed:
        rec["packed"] = packed  # the packed address, baseline5's first batch
    return rec


def main() -> int:
    with _reaping():
        return _smoke()


def _smoke() -> int:
    if not os.path.isdir(os.path.join(HERE, "fast_tffm_tpu_torch")):
        fail("fast_tffm_tpu_torch/ not found beside chip_smoke.py: run it from a "
             "checkout of the repository", code=2)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = phase_device()
    phase_build()
    rng = np.random.default_rng(SEED)
    fwd = phase_anova(rng)
    bwd = phase_anova_bwd(rng)
    fm2 = phase_fm2(np.random.default_rng(SEED + 21))
    dcn = phase_dcn_cross(np.random.default_rng(SEED + 23))
    only = sys.argv[2] if sys.argv[1:2] == ["--only"] and len(sys.argv) == 3 else None
    if only == "fm2":
        return 0  # the order-2 and DCN-V2 pairs' holds and times alone (no result line)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp, contextlib.ExitStack() as ends:
        ends.callback(_stop_children)  # before the directory goes
        train_path, valid_path, big_path = phase_data(tmp)
        if only == "dcnv2":
            # DCN-V2 through train, predict and serve alone (no result line).
            phase_dcnv2(tmp, phase_data_zoo(tmp))
            return 0
        if only == "drivers":
            # This slice's phases alone (no kernels line, no result line).
            phase_drivers(tmp)
            return 0
        if only == "tools":
            # The chaos, soak and tiered-probe tools alone (no result line).
            phase_tools(tmp)
            return 0
        if only == "quality":
            # The quality tools and the fm3 hold alone (no result line).
            phase_quality(tmp)
            return 0
        if only == "pod":
            # A short run of this slice's phases alone (no result line).
            _, pod_ref = phase_dist_cached(np.random.default_rng(SEED + 18), tmp, train_path,
                                           valid_path, big_path)
            phase_pod_card(tmp, pod_ref, dev["nvidia_smi"])
            return 0
        b2_jobs = _start_b2_data(tmp)
        if only == "orbax":
            # This slice's checks alone (no result line): the fixture, the
            # serving reload of an orbax directory, baseline2 with orbax.
            phase_orbax_fixture()
            _only_serve_reload_orbax(tmp)
            phase_dist_b2(tmp, b2_jobs)
            return 0
        if only == "dist":
            # A short run of this slice's phases alone (no result line).
            phase_dist_b2(tmp, b2_jobs)
            phase_dist_b5(np.random.default_rng(SEED + 15), tmp, train_path, valid_path)
            phase_shard_update(np.random.default_rng(SEED + 16), train_path)
            phase_nccl_world1(np.random.default_rng(SEED + 17), train_path)
            return 0
        zoo_paths = phase_data_zoo(tmp)
        phase_parse(train_path)
        tail = phase_rows_tail(rng, train_path)
        tail_shapes = {
            "baseline1": phase_rows_tail_zoo(rng, "baseline1", zoo_paths["criteo"][0], 16384, 39, 9),
            "baseline3": phase_rows_tail_zoo(rng, "baseline3", zoo_paths["avazu"][0], 8192, 22, 89),
        }
        fused_tail = phase_fused_tail(rng, train_path)
        cuda_cfg, launches = phase_train(rng, tmp, train_path, valid_path)
        phase_predict(cuda_cfg)
        fused_cfg, fused_launches = phase_train(rng, tmp, train_path, valid_path, fused=True)
        phase_predict(fused_cfg, "predict_packed")
        phase_serve(rng, tmp)
        zoo = {}
        for key, (_, data) in ZOO.items():
            zoo[key] = phase_train_zoo(rng, tmp, key, zoo_paths)
            cfg = zoo[key]["cuda_cfg"]
            phase_predict(cfg, f"predict_{key}", rows=ZOO_DATA[data]["valid"], anova=False,
                          atol=_score_atol(cfg))
            phase_serve_zoo(key, cfg, zoo_paths[data][1])
        dcnv2_launches = phase_dcnv2(tmp, zoo_paths)
        cached_deepfm = phase_train_cached_deepfm(tmp, zoo_paths, zoo["deepfm"])
        phase_train_fmb(rng, tmp, train_path, valid_path)
        graphed = phase_train_cached(rng, tmp, train_path, valid_path, fused=False)
        graphed_fused = phase_train_cached(rng, tmp, train_path, valid_path, fused=True)
        packed_tail = phase_packed_tail(rng, train_path)
        streamed = phase_resume_streamed(rng, tmp, train_path, valid_path)
        resumed = {
            "resume_streamed": streamed["launches"],
            "resume_fmb_shuffled": phase_resume_fmb_shuffled(rng, tmp, train_path, valid_path),
            "resume_cached": phase_resume_cached(rng, tmp, train_path, valid_path, fused=False),
            "resume_cached_fused": phase_resume_cached(rng, tmp, train_path, valid_path,
                                                       fused=True),
        }
        convert = phase_convert(rng, tmp, train_path, valid_path)
        packed = {acc: phase_train_packed(rng, tmp, train_path, valid_path, acc)
                  for acc in ("element", "row")}
        dedup = phase_train_dedup(tmp, streamed)
        # loadgen (its kernels run in its subprocesses) beside the phases
        # from telemetry_train to tiered_big, whose gates are bitwise or
        # functional: the script's 1200 s bound, on a slow host, does not
        # hold it at the end (its rates here are not the record).
        loadgen = _Beside(phase_loadgen, tmp, "telemetry_train..tiered_big")
        # This slice's phases (their own seed: the phases above keep their data).
        observed = {"telemetry_train": phase_telemetry_train(tmp, cuda_cfg),
                    "telemetry_cached_replays": phase_telemetry_cached(tmp, cuda_cfg)}
        phase_telemetry_serve_predict(np.random.default_rng(SEED + 8), tmp, cuda_cfg)
        saved = phase_ckpt_async(tmp, cuda_cfg)
        observed.update(saved["launches"])
        observed.update(phase_ckpt_delta(tmp, cuda_cfg, saved))
        observed.update(phase_ckpt_ffm(tmp, zoo["ffm"]))
        # This slice's phases: hot reload in process, then the socket tier.
        reload_out = phase_serve_reload(np.random.default_rng(SEED + 9), tmp, cuda_cfg,
                                        fused_cfg)
        served = {"serve_reload": reload_out["anova_launches"],
                  **phase_serve_socket(np.random.default_rng(SEED + 10), tmp, reload_out)}
        # This slice's phases: rollback, the supervisor, follow, accumulator restarts.
        observed.update(phase_rollback(np.random.default_rng(SEED + 11), tmp, train_path,
                                       valid_path))
        observed.update(phase_supervised(np.random.default_rng(SEED + 12), tmp, train_path,
                                         valid_path))
        observed.update(phase_follow(tmp, train_path, valid_path))
        observed.update(phase_accum_restart(np.random.default_rng(SEED + 13), tmp, train_path,
                                            valid_path))
        # This slice's phases: the packed wire, the tiered store, a 2^31 - 1 vocabulary.
        observed.update(phase_wire(np.random.default_rng(SEED + 14), tmp, train_path))
        observed.update(phase_tiered(tmp, train_path, valid_path))
        observed.update(phase_tiered_big(tmp))
        served_by_loadgen = loadgen.result()
        # This slice's phases: dist_train / dist_predict at full width, the
        # shard apply at R = 2 and 4, NCCL at world size 1.
        phase_orbax_fixture()
        # bench_all_torch.py (a measuring driver) from here to the end of
        # pod_card, beside the dist and quality phases (whose gates are
        # bitwise or functional) and waited for before the measured phases;
        # the quality tools beside dist_b2: their runs' launches join the
        # kernels line below.
        bench_all_started = _start_driver(BENCH_ALL_ARGS)
        quality = phase_quality(tmp, beside=lambda: phase_dist_b2(tmp, b2_jobs))
        observed.update(quality["beside"])
        observed.update(phase_dist_b5(np.random.default_rng(SEED + 15), tmp, train_path,
                                      valid_path))
        phase_shard_update(np.random.default_rng(SEED + 16), train_path)
        phase_nccl_world1(np.random.default_rng(SEED + 17), train_path)
        # This slice's phases: the resident epoch under dist_train, a pod of
        # one host re-exec'd into its next generation.
        cached, pod_ref = phase_dist_cached(np.random.default_rng(SEED + 18), tmp, train_path,
                                            valid_path, big_path)
        observed.update(cached)
        phase_pod_card(tmp, pod_ref, dev["nvidia_smi"])
        bench_all = phase_bench_all(bench_all_started)
        phase_throughput(tmp, big_path)
        phase_telemetry_cost(tmp, big_path)
        # The measuring drivers as a user runs them, and B4 and B3 held
        # against their twins at the drivers' Zipf shapes: bench_all_torch.py
        # and loadgen (started above) ended before the measured phases; the
        # chaos, soak and beyond-HBM tools run beside the bench, kstep_big
        # and zipf_tail phases.
        tools = phase_tools(tmp, beside=phase_bench_legs)
        drivers = phase_drivers(tmp, bench_legs=tools["beside"], bench_all=bench_all,
                                serve=served_by_loadgen)
    src = "fast_tffm_tpu_torch/csrc/"
    # Launches: the wrappers' counts over the main path, the eager train run
    # (train_fused for B3; 24 steps: B1 once per step and per validation
    # batch, B2 and the tail once per step).  Beside them, the graphed
    # device-cached runs' steps (48, every 8 one CUDA-graph replay), counted
    # in their profiler traces, and B4's over the zoo's eager runs and the
    # graphed DeepFM run's replays.
    by_run = lambda k, eager, graph: {"train": eager[k], "train_cached_replays": graph[k]}  # noqa: E731
    b4_runs = by_run("rows_tail_adagrad", launches, graphed)
    b4_runs.update({f"train_{key}": z["launches"]["rows_tail_adagrad"] for key, z in zoo.items()})
    b4_runs["train_cached_deepfm_replays"] = cached_deepfm["rows_tail_adagrad"]
    # This slice's runs: each resume phase's three runs (the graphed ones'
    # replays from their traces), convert's train run, the packed element/row
    # runs and the dedup runs.
    for phase, runs in resumed.items():
        for run, counts in runs.items():
            b4_runs[f"{phase}_{run}"] = counts["rows_tail_adagrad"]
    b4_runs["convert_train"] = convert["rows_tail_adagrad"]
    for acc, counts in packed.items():
        b4_runs[f"train_packed_{acc}"] = counts["rows_tail_adagrad"]
    for k, counts in dedup.items():
        b4_runs[f"train_dedup_{k}"] = counts["rows_tail_adagrad"]
    b3_runs = by_run("fused_tail_adagrad", fused_launches, graphed_fused)
    for run, counts in resumed["resume_cached_fused"].items():
        b3_runs[f"resume_cached_fused_{run}"] = counts["fused_tail_adagrad"]
    # The telemetry, checkpoint, rollback, supervised reference, follow and
    # accumulator-restart runs (K-step runs: the replays in their traces),
    # under each kernel that ran in them.
    fwd_runs, bwd_runs = by_run("anova_fwd", launches, graphed), by_run("anova_bwd", launches,
                                                                          graphed)
    # The order-2 pair: the zoo's order-2 FM and DeepFM eager runs (its main
    # path: train_fm2) and the graphed DeepFM run's replays.
    fm2_runs = {k: {f"train_{key}": zoo[key]["launches"][k] for key in ORDER2_ZOO}
                for k in ("fm2_fwd", "fm2_bwd")}
    for k, runs in fm2_runs.items():
        runs["train_cached_deepfm_replays"] = cached_deepfm[k]
    pairs = ((fwd_runs, "anova_fwd"), (bwd_runs, "anova_bwd"), (b4_runs, "rows_tail_adagrad"),
             (b3_runs, "fused_tail_adagrad"), (fm2_runs["fm2_fwd"], "fm2_fwd"),
             (fm2_runs["fm2_bwd"], "fm2_bwd"))
    for runs, kernel in pairs:
        runs.update({run: counts[kernel] for run, counts in observed.items() if counts[kernel]})
    # The serving runs' forward launches: the in-process reload engine's
    # (wrappers zeroed before it), and each replica process's during the
    # socket traffic (its stats after less before).
    fwd_runs.update(served)
    # The drivers' runs: each subprocess's wrapper counts (bench_torch,
    # bench_all_torch, the in-process loadgen engines) and the socket tier's
    # replicas' (their stats).
    for runs, kernel in pairs:
        runs.update(drivers["launches"][kernel])
    b4_runs.update(tools["launches"])
    for runs, kernel in pairs:
        runs.update(quality["launches"][kernel])
    tail_shapes["zipf_packed_b65536"] = drivers["zipf"]["rows_tail_adagrad"]
    emit({"kernels": [
        _kernel_record("anova_fwd", src + "anova_fwd.cu",
                       "fast_tffm_tpu/ops/pallas_anova.py:66", launches["anova_fwd"], *fwd,
                       fwd_runs),
        _kernel_record("anova_bwd", src + "anova_bwd.cu",
                       "fast_tffm_tpu/ops/pallas_anova.py:91", launches["anova_bwd"], *bwd,
                       bwd_runs),
        _kernel_record("rows_tail_adagrad", src + "rows_tail_adagrad.cu",
                       "fast_tffm_tpu/ops/pallas_tail.py:267", launches["rows_tail_adagrad"],
                       *tail, b4_runs, shapes=tail_shapes, packed=packed_tail),
        _kernel_record("fused_tail_adagrad", src + "fused_tail_adagrad.cu",
                       "fast_tffm_tpu/ops/pallas_tail.py:119",
                       fused_launches["fused_tail_adagrad"], *fused_tail, b3_runs,
                       shapes={"zipf_fused_b65536": drivers["zipf"]["fused_tail_adagrad"]}),
        *(_kernel_record(k, src + "fm2_score.cu", "none: the JAX package leaves order 2 to XLA",
                         zoo["fm2"]["launches"][k], fm2[0],
                         {"ms": fm2[1][f"{part}_ms"], "device_ms": fm2[1][f"{part}_device_ms"],
                          "plain_ms": fm2[1]["plain_ms"], "bound_ms": fm2[1][f"{part}_bound_ms"],
                          "bound_by": fm2[1][f"{part}_bound_by"]}, fm2_runs[k])
          for k, part in (("fm2_fwd", "fwd"), ("fm2_bwd", "bwd"))),
        *(_kernel_record(k, src + "dcn_cross.cu", "none: DCN-V2 is the port's own model",
                         dcnv2_launches[k], dcn[0],
                         {"ms": dcn[1][f"{part}_ms"], "device_ms": dcn[1][f"{part}_device_ms"],
                          "plain_ms": dcn[1]["plain_ms"], "bound_ms": dcn[1][f"{part}_bound_ms"],
                          "bound_by": dcn[1][f"{part}_bound_by"]},
                         {"train_dcnv2": dcnv2_launches[k]})
          for k, part in (("dcn_cross_fwd", "fwd"), ("dcn_cross_bwd", "bwd"))),
    ]})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"], "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
