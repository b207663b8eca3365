#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dragonfly2_tpu_torch``) on one GPU.

Drives the scheduler's ML parent-ranking path through the port's own
entry points and holds every kernel of that path against its plain
PyTorch version.  Imports nothing of JAX or of the JAX package.

Phases:

1. Device and build: the card's name and power limit, the kernels built
   from ``dragonfly2_tpu_torch/csrc`` with nvcc for sm_90a (timed).
2. Serving path: ``cli.scheduler.build`` with algorithm ``ml``, a
   65,536-slot host store, the 1.5 ms batcher, a fused scorer made
   from a seeded 32→64→64→1 scorer blob and record storage under the out
   directory.  16,384 synthetic hosts announce; 64 tasks are warmed with
   64 downloads each (256, then 128, cut for the run's time; register,
   task length, every piece from the first
   scheduled parent or the source, finished: one Download record each,
   checked); then 32 threads send 16 ``register_peer`` requests each,
   every one into a task where its host has no peer yet, and one client
   sends 64 more (the uncontended per-layer breakdown).  The rule arm
   (K2) then scores the rule components of the same candidate sets.
   Launch counts are zeroed just before this phase and read just after.
3. The path against the reference: K1 launches equal the batcher's
   scorer calls, no batcher fallback, no announce degraded to the rule
   ranking, >= 90% of the requests scored >= 2 candidates.  Then, with
   the cluster state frozen, every recorded candidate set is ranked again
   through the evaluator and scored by K1 directly, and held to the
   numpy ``MLPScorer`` on ``_featurize_batch`` rows: scores within 1e-4,
   orders equal wherever adjacent reference scores differ by > 1e-4.
   The scorer made one upload and one download per K1 launch.
4. Kernels against their plain versions on the same inputs: K1 at the
   path's padded sizes (128, 256, 512 rows) and at 4,096 rows over the
   full 65,536-row mirror, K2 at [512, 6].
5. Times from CUDA events (median of 25): K1 at 128 rows (the pad most
   flushes take) and 512, and the launch floor (an empty launch,
   ``torch.cuda._sleep(1)``, timed the same way).  K2 on its row ladder
   (``bench/k2_ladder.py``): 512 rows, 65,536 (in L2) and 16,777,216 (470
   MB, cold on every launch), each tiled from the rule arm's components,
   held to its plain version (and on the view one row in), timed beside
   its plain version and ``torch.mv``, with its bound and share.  The announce
   rate and register_peer p50/p99 are those of the 512 concurrent
   requests (a closed loop of 32 clients); evaluate_parents and the
   scorer flush are timed per call around the same requests.
6. Training path: the GAT parent-peer ranker (BASELINE configs[2]) at
   full width — a 100,000-host synthetic cluster, its probe graph at 16
   probes a host, ``build_neighbor_table`` with K = 16, 1,310,720
   download edges with log1p ground-truth bandwidth targets — trained by
   ``train_gat_ranker`` on the card with ``GNNConfig()`` defaults (hidden
   128, out 64, 2 layers, 4 heads, embed 32, dropout 0.1) and the K3
   neighbor gather, batch 131,072, 2 epochs (18 steps).  Launch counts
   are zeroed just before ``train_gat_ranker`` and read just after.
   Checks: K3 launches = 2 × steps; finite losses, the last 3 steps'
   mean below the first; finite validation metrics; one train step with
   the K3 gather against the same step with the index gather's own
   backward (dropout from the same generator state; loss within 1e-3
   relative, gradient abs-sum within 5e-2); the exported GNN scorer
   (``export_gnn_scorer`` → blob → ``load_scorer``) against the model's
   validation predictions.  Then K3 against its plain version at the
   path's two shapes (bf16, D 44 and 128, over the real bucketed
   layout), at an f32 ``exact=True`` shape, with zero edges and with an
   empty node block; and its device time (and its two passes' from
   ``torch.profiler``), its plain version's and ``index_add_``'s at the
   path's shapes, and the train step time.

Prints JSON lines, the ``kernels`` line second to last and the contract
line ``{"ok": true, "device": {...}}`` last.  Any failed check exits
non-zero before that line.  Exits 2 without a result when no CUDA device
is available.

The training phase ends with three more train steps under
``torch.profiler``: device time by kernel and the device's idle share of
the steps' wall time (``training_profile`` line).

7. Streaming path (``stream``): the MLP bandwidth regressor (BASELINE
   configs[4]) at full width — ``StreamingConfig()`` and ``MLPConfig()``:
   batch 4,096, 32→256→256→128→1, bf16 compute with f32 params — trained
   by ``StreamingTrainer`` on the card from 1,048,576 rows (256 steps)
   drawn from the lifecycle drill's seeded ground truth.  Prints step ms
   (per-step host time, p50 over steps 16-255, no sync inside the window;
   and the window's synced mean), records/s, peak memory and a
   ``torch.profiler`` breakdown of 16 more steps.  The step-128
   checkpoint and the copy of the step-144 parameters are taken outside
   the timed window.  Checks: the loss falls (mean of the last 16 steps
   below the first 16); the step-128 checkpoint resumed in a fresh
   trainer takes steps 129-144 on the same batches to bit-identical
   parameters; the exported scorer carries drift bins, its
   numpy scores on 4,096 held rows are within 3e-2 × max(1, |score|) of
   the bf16 module's and 1e-4 of a float32 twin's, and its blob
   round-trips through ``scorer_to_bytes`` / ``load_scorer``.
8. Lifecycle (``lifecycle``): ``run_lifecycle_drill(LifecycleDrillConfig(),
   device="cuda")`` — train → export → register → SHADOW → CANARY →
   ACTIVE, an injected regression rolled back, a manager bounce resumed.
   Checks ``ok`` and the rollback; prints the three stage times.
9. Rollout serving (``rollout_serving``): the drill's plane on a fresh
   ``MemoryBackend`` feeding a port scheduler (``build`` with algorithm
   ``ml``, no blob, on the card, record storage under the out directory)
   through a ``ModelSubscriber``: each
   round is ``daemon.step()``, ``subscriber.refresh()`` and 16
   ``register_peer`` calls, until v1 is ACTIVE.  Checks: one Download
   record per finished warm-up download (deleted after), a shadow engine
   attached in every SHADOW round, a canary route in every CANARY
   round, v1 served at the end, and every ML-scored announce's scores
   equal, bit for bit, to the registry artifact's numpy scorer on the
   same feature matrix.

No kernel of the port runs on paths 7-9 (the streaming scorer is
standardized and 4 layers deep, which K1 does not serve; the subscriber
installs what ``load_scorer`` returns, as the reference does): their
launch counts are zeroed before each and must read 0 after.

10. The flagship (``hop``): the hop ranker at full width on phase 6's
    workload (100,000 nodes, K 16, 1,310,720 download edges, batch
    131,072) with ``HopConfig(hidden=1024)`` (2 hops, embed 32, dropout
    0.1, bf16 compute) and phase 6's ``TrainConfig``: once for phase 6's
    2 epochs (18 steps; its validation metrics printed beside the GAT's)
    and once for 6 epochs (54 steps), which the checks, the export and
    the times read: after 18 steps the validation MAE sits at the mean
    predictor's, too close to hold it to.  The hop features are
    precomputed once on the card (timed), then ``train_hop_ranker``
    trains on them and ``export_gnn_scorer`` bakes the scorer.  Checks:
    54 steps, finite losses falling (the last 3 steps' mean below the
    first), validation MAE below the train-mean predictor's, the
    exported scorer within 3e-2 × max(1, |score|) of the model's
    validation predictions, no kernel launched (the hop ranker has
    none); the 18-step run's validation MAE not above the mean
    predictor's.  Prints step ms (host, p50 from step 3 on, each synced by its
    loss) and from CUDA events over 10 more steps with no sync inside,
    records/s, MFU (dense operations from the shapes over the events
    step and the bf16 dense peak), peak memory, validation MAE and F1
    beside the GAT's, and a ``torch.profiler`` breakdown of 3 steps.
11. The trainer service (``trainer_service``): 65,536 download rows from
    a 16,384-host ``SyntheticCluster`` and the topology rows of 16,384
    ``generate_topology_records`` over the same hosts, written as DFC1
    shards with the port's ``ColumnarWriter``; then
    ``cli.trainer.run(["--train-once", DIR, "--device", "cuda"])`` with
    the default config (30 epochs, lr 3e-3: 420 MLP steps at batch
    4,096, 840 hop steps at batch 2,048).  Checks: exit 0, the two
    models registered (``parent-bandwidth-mlp`` and
    ``parent-ranker-gnn``), both artifacts load through ``load_scorer``
    and score finite values, no kernel launched.  Prints the round's
    seconds from shards to registered models and each model's metrics.
    Then ``TrainerService(gnn_model="gat", device="cuda")`` trains once
    more on the same shards under the round's config (840 GAT steps);
    its GAT gather's backward is K3.  Launch counts are zeroed just
    before this run and read just after.  Checks: K3 launches = steps ×
    GAT layers; K3 against its plain version on the run's own first
    backward input and plan (taken by a tap), within 1e-5 × max |sum|
    (no floor: the gradients are far below 1); the GAT's validation MAE
    below the train-mean predictor's.  K3's device time there is printed
    beside its plain version's and ``index_add_``'s on the same input
    (the library call for the same sums).
    The kernels line's K3 launches are phase 6's plus this run's.
12. The scheduler's record and probe half (``swarm``):
    ``cli.scheduler.run(["--simulate", "500", "--device", "cuda"])`` with
    ``DRAGONFLY_SCHEDULER_STORAGE_DIR`` under the out directory (exit 0
    and the reference's line); then ``SwarmSimulator`` over 1,000
    ``SyntheticCluster`` hosts (BASELINE configs[1]'s 1k peers) with one
    seeded ``random.Random`` for scheduling and probe targets:
    ``run_downloads(10000, tasks=64)`` (configs[0]'s 10k download
    records), ``run_probe_rounds(8)``, ``snapshot_topology()`` into
    ``Storage``; the host time of each, the DFC1 row counts and the probe
    graph's edges and in-degree.  Then ``cli.trainer.run(["--train-once",
    DIR, "--device", "cuda"])`` on those shards (exit 0, both models
    registered; the round's seconds, each model's metrics), and
    ``measure_parent_choice_quality`` (200 trials, seed 1234) for the rule
    evaluator, the nt evaluator over the swarm's probe store, and an
    ``MLEvaluator`` fed each registered model by a ``ModelSubscriber``:
    the MLP and the GNN must each beat the rules.  No kernel launches.
13. GraphSAGE (``sage``, configs[1]) on phase 12's probe graph:
    ``to_edge_arrays()``, the cluster's host features in the store's id
    order, ``build_neighbor_table`` with K 16, the target
    ``log1p(rtt / 1e6)``; ``train_graphsage`` with ``GNNConfig()``
    (hidden 128, out 64, 2 layers, embed 32, dropout 0.1, bf16) and the K3
    gather, ``TrainConfig(epochs=30, learning_rate=3e-3,
    warmup_steps=20)``, batch 4,096.  Launch counts are zeroed just before
    and read just after.  Checks: K3 launches = 2 × steps; the loss falls
    (the last 8 steps' mean below the first 8's); the validation MAE below
    the train-mean predictor's; K3 against its plain version on the run's
    own first backward input and plan (a tap), within 1e-5 × max |sum|;
    one step with the K3 gather against the same step with the index
    gather and with the transpose gather (loss within 1e-3 relative,
    gradient abs-sum within 5e-2, gradient L2 difference within 1e-2 of
    the K3 step's gradient norm); K3 against its plain version at
    [16,000, 44] and [16,000, 128].  Prints each gather's step p50 (host
    clock, 20 steps each, in turns) and the fastest, K3's device time,
    bound and ``index_add_``'s at the two shapes, and the idle share of 5
    profiled steps.  The kernels line's K3 launches add this run's.
14. The online graph trainer (``online_graph``, BASELINE configs[4] as the
    north star writes it) at full width: 100,000 nodes, K 16,
    ``HopConfig(hidden=1024)``, batch 131,072, 8 steps a dispatch,
    ``topo_window`` 1,600,000, through ``bench/online_graph.run``.  Run A
    (``--wire``, 16 dispatches, 16.8 M records): a producer thread sends
    ``generate_feature_rows`` blocks and per-epoch probe sweeps as DFC1
    chunks through ``TrainerService.receive_shard_bytes`` into
    ``WireIngestAdapter``; snapshot 0 is built from the first wire sweep,
    and the driver refreshes after dispatches 4, 8 and 12 with a stale and
    a fresh validation MAE around each.  Checks: finite losses, the last 4
    dispatches' mean below the first 4's; rows trained = rows sent = rows
    off the wire, none left over or dropped; 3 refreshes (snapshot_idx 4
    with the wire bootstrap, which waits for the first sweep and the first
    download rows); at the last refresh (96 steps in), on the post-drift
    validation edges, the fresh snapshot's MAE not above the stale one's
    (every refresh's pair is printed: after 32 steps a refresh still costs
    MAE, PERF.md §6 PR 7); no kernel launched.  Then one block is dispatched 3 times from one saved
    state with the embedding's sorted backward (the hashes must agree) and
    3 times with ``index_select``'s (reported), and 2 dispatches are
    profiled.  Runs B and C (direct feed, 8 dispatches, a refresh after 4):
    B straight; C checkpoints after dispatch 6 and stops; a third trainer
    resumes C (dispatch 6, snapshot 1) and runs to 8: its ``state_hash``
    must equal B's.  Prints records/s through the service, dispatch ms
    from CUDA events, refresh seconds (table build, precompute), stale and
    fresh MAE, the adapter's counts, peak memory and the idle share.
15. Federated FedAvg (``federated``, configs[3]): 8 ``SyntheticCluster``
    shards of 1,000 hosts (each its own seed: non-IID), 10,000 rows each
    plus 2,000 held out; ``FederatedConfig()`` (5 rounds, 3 local epochs,
    batch 1,024) and ``MLPConfig()`` on the card.  Checks: the held-out MAE
    falls across rounds and ends below the pooled-mean predictor's; the
    last round's aggregate equals the reference's numpy weighted mean of
    the 8 local models (float32, in shard order) within 1e-6; ``publish`` → ``load_scorer`` scores within 1e-5 ×
    max(1, |score|) of a float32 twin of the global model and 3e-2 × max(1,
    |score|) of the bf16 model; no kernel launched.  Prints seconds per
    round, MAE per round and records/s.
16. The deployment over real sockets (``wire_loop``), through
    ``bench/wire_loop.run`` at the swarm phase's size (configs[1]'s 1,000
    ``SyntheticCluster`` hosts; the downloads cut from 10,000 to 4,000
    and the probe rounds from 8 to 4 for the phase's time): a
    ``ManagerRESTServer``, the
    trainer's serve composition on the card (``cli.trainer.serve``, the
    GAT branch, ``RemoteRegistry`` to the manager), the scheduler's
    (``cli.scheduler.serve``: ``ml``, the probe store, the seed-made
    32→64→64→1 blob, the manager link with a 1 s model poll, the trainer
    link every 60 s) and a rule-ranking scheduler, each on an ephemeral
    port.  1,000 hosts announce, 128 seeding and 1,500 concurrent
    downloads go through one ``RemoteScheduler`` per host from 16 client
    threads, then 256 from one client; 4 probe rounds through
    ``sync_probes_start`` / ``sync_probes_finished``; the probe graph is
    snapshotted into the scheduler's records; the Announcer's next round
    uploads the shards and the trainer trains the MLP and the GAT, which
    register in the manager; 40 parent-choice trials (``WIRE_TRIALS``)
    run on the seed-made K1 scorer, then the MLP is activated over REST
    and, once the subscription has installed it, 60 more, and 60 on the
    rule scheduler.  Launch counts are zeroed just before and read just after.
    Checks: K1 launches > 0 and equal to the batcher's fused flushes
    before the swap, none after; K1 against its plain version on 64 of
    the path's flushes; rows staged = rows written (downloads and
    topology); both models registered; K3 launches = GAT steps, K3
    against its plain version on the GAT run's own first input; the
    installed MLP's MB/s above the rules'; every trial answered with
    parents.  Then each binary boots once as a child process (``python -m
    dragonfly2_tpu_torch.cli.{scheduler,trainer} --device cuda``), answers
    one request and exits 0 on SIGINT.
17. The self-driving lifecycle over the same sockets (``wire_lifecycle``),
    through ``bench/wire_loop.run`` with ``--lifecycle`` at the same size:
    the trainer's serve composition runs the lifecycle daemon
    (``LifecycleSection`` defaults but its 2 s cycle; the streaming MLP
    at ``MLPConfig()`` widths on the card) for the scheduler's id, the
    manager serves a ``RolloutController`` (the reference's guardrails
    but the drift ceiling, which is off), and the ``ml`` scheduler
    shadow-scores every announce into ``shadow_replay.dfc`` and reports
    every 5 s; the Announcer runs every 45 s.  After the seed scorer's
    40 parent-choice trials, downloads run until a daemon candidate is
    ACTIVE and installed; then 40 trials on the installed model and 40
    on the rules.  Launch counts are zeroed just before and read just
    after.  Checks: the candidate's rollout row read over REST goes
    SHADOW, CANARY, ACTIVE, after the seed scorer's parent choice, with 0
    ``:activate`` calls; every subscriber commit while SHADOW has the
    shadow engine and no canary route, every one while CANARY both at 10
    %; the installed version is the promoted daemon version and served
    scores after the install equal the registry artifact's; rows fed to
    the daemon equal the download rows uploaded; shadow rows on disk
    equal those logged and read back; the daemon's parameters on the
    card; K1 launches > 0 and equal to the fused flushes before the
    install, none after; K1 against its plain version on 64 of the
    phase's flushes; no K3 launch; every trial answered with parents.
18. Multi-device training on ``torch.distributed`` (``multidevice``), at
    the flagship's width on phase 6's workload (100,000 nodes, K 16,
    1,310,720 download edges, batch 131,072, ``HopConfig(hidden=1024)``,
    ``GNNConfig()``).  (a) NCCL, world 1, in this process (a ``FileStore``
    in the out directory, no port), a (1 x 1) mesh:
    ``precompute_hop_features_sharded`` against ``precompute_hop_features``
    within 1e-5 x max(1, |x|); ``train_hop_ranker(mesh=,
    node_sharding="model")`` for phase 10's 18 steps, its losses within
    1e-3 relative of phase 10's and its validation MAE within 5e-3, and
    the same run replicated on the mesh; ``train_gat_ranker(mesh=)`` with
    the K3 gather for 18 steps: K3 launches = steps x layers, K3 against
    its plain version on the run's first backward input within 1e-5 x
    max |sum|, losses within 1e-3 of phase 6's.  The collective wrappers'
    counts equal what the steps imply (no shortcut at world 1).  Step ms
    p50 with and without the mesh, and peak memory.  (b) four gloo ranks
    spawned on the one card (NCCL refuses two ranks on one device), a
    (2 data x 2 model) mesh: the halo precompute against the replicated
    one within 1e-5 x max(1, |x|); 6 node-sharded flagship steps against
    6 replicated ones, losses within 1e-3 relative; the plan's H against
    S and the halo bytes per hop against a full all-gather's.  The phase
    must end within 150 s.
19. Tracing, telemetry and tenant QoS on the K1 serving path
    (``telemetry_qos``).  ``cli.scheduler.build`` at phase 2's sizes
    (16,384 hosts, 65,536 slots, the 1.5 ms batcher, the seeded K1
    scorer), 64 tasks warmed with 32 downloads each (phase 2's 64 cut
    for time); a three-tenant ``QoSPolicy`` (DRR weights 4 : 2 : 1)
    installed through ``service.on_qos_config``; ``init_telemetry``
    with a metric journal (1 s) and one latency SLO on
    ``scheduler_eval_flush_seconds``.  Three arms, each run twice in
    the mirrored order off, 0.1, 1.0, 1.0, 0.1, off (a run: 32 threads
    x 16 ``register_peer`` calls, each thread pinned to one tenant):
    tracing off, ``init_flight_recorder`` with a durable log at sample
    rate 0.1 (the config default), and at 1.0.  Launch counts are zeroed
    just before the runs and read just after.  Checks on every run:
    flush-sketch observations = the batcher's dispatch groups = drains;
    at 1.0, ``scheduler/eval.flush`` spans replayed from the run's log =
    spans exported = flush observations, and the spans' ``rows`` sum to
    the rows drained; at 0.1, the log holds every span exported and
    exported + sampled out = flushes.  Every request answered; K1
    launches = the batcher's scorer calls; K1 against its plain version
    on 64 of the phase's flushes; the journal, replayed, ends on the
    registry's flush count; the SLO engine evaluated a window; the
    announce answer carries ``tenant_qos``.  Printed: announces/s and
    register p50 / p99 per arm (both runs pooled) and per run, each
    tenant's share of the rows drained, and the flushes that drained
    two or more tenant lanes.  The flight-recorder reader
    (``bench/trace_assemble``) then reads each traced run's log:
    ``build_report``'s traces and frames, the anomalies over every
    assembled trace, and the ``scheduler/eval.flush`` spans assembled,
    which must equal the spans replayed, with 0 corrupt frames.
20. The peer daemon's download path (``peer_swarm``):
    ``bench/peer_swarm.run`` in this process, under the out directory: an
    origin (a stdlib HTTP server with ``Range``) serving a 256 MiB file
    made from the seed; ``cli.scheduler.serve`` with algorithm ``ml`` and
    the seeded K1 scorer; 16 daemons, each ``cli.dfdaemon.build`` with the
    default 4 MiB pieces (64 pieces) and its own piece server, announced.
    Daemon 0 downloads the file back to source, daemons 1-15 then at the
    same time, and last one ``cli.dfget --daemon`` download goes through
    a ``DaemonControlServer`` over daemon 15 (``DF_DAEMON_STATE`` under
    the out directory).  Launch counts are zeroed just before the run and
    read just after.  Checks: every output's sha256 equals the origin's;
    only daemon 0 went back to source and the origin served at most 1.25
    x the file (when the evaluator's bad-node rule excluded daemon 0 as a
    parent: daemon 0 served nothing, one more daemon went back to source,
    1.25 x the file for each); pieces from peers and from the source add up to 16 x 64
    (the source's equal the origin's range requests, the peers' the
    daemons' upload counts up to the serves of hedged fetches' losing
    arms and of failed fetches); one Download record per daemon's
    download; no evaluator
    degrade; K1 launches = the batcher's scorer calls > 0; K1 against its
    plain version on the phase's own flush rows.  Printed: wall seconds,
    aggregate MB/s, per-daemon MB/s p50 / p99, origin bytes, pieces by
    source and parent host, K1 launches, its time at the phase's flush
    rows and its error.  The phase writes 4 GiB and deletes it at the end.
21. Preheat and the seed peer (``preheat_swarm``):
    ``bench/preheat_swarm.run`` in this process, under the out directory:
    two origins (file A, 256 MiB, made from the seed as in phase 20; file
    B, 64 MiB); ``cli.manager.serve``; ``cli.scheduler.serve`` with
    algorithm ``ml``, the seeded K1 scorer, the manager's URL and
    ``dynconfig_refresh_s`` 1 (the job worker's long poll cut to 1 s);
    one ``cli.dfdaemon.seed_peer`` composition (SUPER_SEED) and 15
    daemons at the default 4 MiB pieces, announced.  A ``preheat`` job
    for A over the manager's REST; the 15 daemons download A at the same
    time; daemon 1 downloads B with no source client (the cold task: the
    scheduler triggers the seed inline); the cluster's
    ``filter_parent_limit`` goes to 6 over REST, and once dynconfig has
    applied it daemons 0 and 2-14 download B.  Launch counts are zeroed
    just before the run and read just after.  Checks: the preheat group
    reads SUCCESS and the origin served A exactly once, all to the seed;
    every sha256 equals its origin's; no normal daemon went back to
    source and the origin's bytes for A stay 1.00 x the file; the cold
    task's pieces all came from the seed and the origin served B once,
    to the seed; the seed was triggered once for each file; the update
    applied within three refreshes and every register after it handed K1
    at most 6 rows; a SUPER_SEED row (column 9) among the scored rows
    and in a recorded flush; no evaluator degrade and no batcher
    fallback; K1 launches = the batcher's scorer calls > 0; K1 against
    its plain version on the phase's own flushes.  Printed: preheat
    seconds, the seed's share of P2P pieces, aggregate MB/s, origin
    bytes, the cold task's trigger seconds, update-to-applied seconds,
    rows per register before and after, the manager's job polls, K1
    launches, its time at the phase's flush rows and its error.  The
    phase writes 4.6 GiB and deletes it at the end.
22. The sharded scheduler fleet (``shard_fleet``).  (a) The columnar
    fleet, ``bench/fleet_swarm.run`` at ``BENCH_SW_r01.json``'s
    configuration: 128,000 peers, 4 shards, 4 ticks, 2 interleaved rounds
    after a warm round, announce rate 0.5, download rate 0.0005, 65,536
    cache hosts, seed 7; one shard killed and one added mid-round.
    Host-only (the rule evaluator): launch counts are zeroed before it and
    must read 0 after.  Checks: 0 failed downloads in both arms and
    downloads completed after the kill.  Printed: announces/s by arm,
    hosts per shard (max), bind misses, handoffs on kill and on add,
    redirects followed.  (b) ``bench/shard_fleet.run`` in this process,
    under the out directory: ``cli.manager.serve``, two
    ``cli.scheduler.serve`` shards in this process and one
    ``python -m dragonfly2_tpu_torch.cli.scheduler`` child
    (``sim.chaos.ChaosProcess``) on the card, all ``ml`` with the seeded
    K1 scorer (the child reads the same blob through ``--scorer-blob``;
    the kernels' library is built in this process first), the manager's
    URL, ``dynconfig_refresh_s`` 0.5 and the shard guard with admission
    at the defaults; 16 daemons at the ``DaemonConfig`` defaults, each
    given the three URLs (``SteeringSchedulerClient``); 8 origin files of
    32 MiB whose URLs give each shard >= 2 tasks by the published ring.
    One daemon per file goes back to source, then 7 more per file: the
    survivors' files first, the child SIGKILLed while they are in flight
    and expired at the manager (its last keepalive aged out of the TTL,
    as the reference's drill does), and the victim's files once both
    survivors and every daemon hold ring v2 (the reference's daemon fails
    a download whose scheduler dies under it).  Launch counts are zeroed
    just before (b) and read just after; they are this process's, so only
    the two in-process shards' K1 launches are seen.  The child runs the
    diagnostics sidecar its ``run`` starts at the reference's defaults
    (``DRAGONFLY_SCHEDULER_METRICS_PORT=0``: an ephemeral port, read off
    its boot line); its ``/metrics`` and ``/debug/spans`` are scraped just
    before the kill.  Checks: every check
    of the run's summary (the child's scraped
    ``scheduler_download_records_total`` equal to the Download records
    read from its storage before the kill, and its ``rpc/register_peer``
    spans in ``/debug/spans``; ring v1 of three, v2 of two and newer, adopted
    by the survivors through dynconfig and carried on announce answers
    and by every daemon; every sha256 equal; the Download records before
    the kill on each task's v1 owner only, the victim's tasks' after it
    on their v2 owners; a handoff span on each survivor; each survivor
    file's origin bytes <= 1.25 x the file; no degrade and no fallback,
    in process or in the child's output); K1 launches = the in-process
    batchers' scorer calls > 0; K1 against its plain version on the
    phase's own flush rows.  Printed: wall seconds, the seconds from the
    kill to ring v2 at the manager, at each survivor and at the first
    daemon, aggregate MB/s, pieces by source, the victim's files' origin
    bytes, sheds by priority and the most requests in flight, K1
    launches, its time at the phase's flush rows and its error.

23. The push-reschedule path (``push``): phase 2's composition (a fresh
    ``cli.scheduler.build`` with algorithm ``ml``, the seeded 32→64→64→1
    K1 scorer, 65,536 host slots, 16,384 synthetic hosts, 64 tasks) with
    a ``scheduler/push.PeerStreamHub`` at the reference's cooldown (1 s)
    on the service.  Each task is warmed with 16 finished downloads
    (phase 2's 64 cut for the phase's time), then 16 running children a
    task register, each subscribing an enqueue callback to the hub that
    encodes the pushed schedule as the gRPC stream binding does
    (``schedule_to_wire``).  Ejection: in each task the warm parent with
    the most children gets one piece cost past the reference's bad-node
    rule through ``report_piece_finished`` from one of its children.
    Stall sweep: a ``StallMonitor`` with its times cut (max idle 10 → 1 s,
    sweep 2 → 0.25 s) runs for 3 s over the idle children.  Launch counts
    are zeroed before the warm-up and read after the sweep.  Checks: the
    bad parent is bad; one push for each of its subscribed children, all
    inside the cooldown of the report, no pushed parent a bad one and no
    child's DAG edge to it left; stall pushes = the sum of the sweeps'
    returns > 0, every stall-pushed child's idle clock restarted at its
    last push; K1 launches = the batcher's scorer calls > 0, K2 and K3 0;
    K1 against its plain version on the push path's own flushes (each on
    its flush-time mirror) and on 2,000 seeded stress flushes
    (``bench/k1_replay.stress``: 1 to 1,024 rows over every pad boundary,
    slots over 65,536 store-like rows, the path's edge rows, 3 launches
    each back to back, each held to plain and to the first launch's
    bits).  Printed: pushes (ejection, stall), pushes/s, report → callback
    p50 / p99 ms, K1 launches and the flush rows checked.
24. The tenant QoS overload drill and the telemetry drills
    (``qos_drill``).  (a) ``sim/qos.run_isolation_drill`` at
    ``QoSDrillConfig()``'s defaults (1,000 tenant-A announces, 6
    downloads of 8 × 64 KiB pieces, 2 tenant-B flood threads at a 10×
    burst, B capped at 50 announces/s and 1e6 B/s shaped, admission at
    256 in flight and a 20 ms p99 budget, seed 7): baseline, unshaped
    and shaped arms, each ranking parents with an ``MLEvaluator`` over
    phase 2's seeded K1 scorer on the card (``bench/bench_qos
    .MLEvaluators``: a fresh 4,096-host store, fused scorer and batcher
    an arm) and ``extra_parents=7``, so each of A's downloads ranks 8
    candidates; then one shaped arm with the reference's rule evaluator
    at the same configuration.  Printed: each arm's report and the four
    movements of A's announce p99 and TTLB (not checks).  Checks, from
    the reference's tests: shaped A downloads all complete, unshaped B
    offered > 100, shaped B shed or throttled > 0, shaped B seed bytes
    below unshaped, the accounting names ``t-a`` gold and ``t-b``
    background; K1 launches > 0 and equal to the batchers' scorer calls,
    K1 held to plain on the phase's flushes (each on its flush-time
    mirror); the shape witness (``utils/dftrace``, installed for the ml
    arms) counts at most its budget of padded sizes a scorer; the rule
    arm launches no kernel.  (b) Host only: ``sim/telemetry
    .run_kill_drill`` (3 children, 400 samples, a snapshot every 50, the
    victim SIGKILLed at its 4th journal write, its tail torn, a
    survivor's frame bit-rotted; fleet quantiles against the exact
    oracle) and ``run_burnrate_drill``, each raising on the reference's
    conditions, in a work directory under the out directory; no kernel
    launches in (b).
25. The trainer service across ranks (``trainer_ranks``), on phase 11's
    shards (65,536 download rows from 16,384 hosts, the topology rows of
    16,384 records) at the service's width (the GAT at
    ``GNNConfig(hidden=64, out_dim=32, num_layers=1, num_heads=2)``,
    batch 2,048) under phase 11's round config cut to 6 epochs (168 GAT
    steps).  ``TrainerService(gnn_model="gat")`` trains once on 2 gloo
    ranks sharing the card (``parallel/launch.RankGroup``: this process
    rank 0, one spawned helper, both on ``cuda:0``), then once with no
    mesh on the card; then ``cli.trainer.run(["--train-once", DIR])`` at
    its defaults but the epochs (6, through the environment).  Launch
    counts are zeroed just before each round and read just after (the
    helper reports its own).  Then the float32 witness: the 2-rank and
    one-device rounds again with every model config in float32 (in every
    rank), and a second float32 one-device round, the control.  Checks:
    each model registered once, by rank 0 (registry calls by rank
    ``[2, 0]``); every rank's parameters equal (the sha256 digests of
    its trained leaves, ``TrainRun.leaf_digests``), in both dtypes; the
    2-rank MLP losses within 1e-3 relative of the one-device losses at
    every step (1e-4 in float32); the GAT's within 5e-3 (the bound
    ``tests/test_torch_multidevice_train.py`` holds bf16 losses to) and
    1e-4 in float32 at every step of the first epoch (past its loss
    spike, ~step 43, the GAT's trajectory amplifies any last-bit
    difference: the control, one device against itself in float32,
    departs by up to 0.26 at a step, as the 2 ranks do in either dtype);
    the bf16 GATs' validation MAE within 10 % of each other; K3 launches
    = steps × GAT layers on each rank and in the one-device run; K3
    against its plain version on rank 0's first backward input, within
    1e-5 × max |sum|; both GATs' validation MAE below the train-mean
    predictor's; the binary at its defaults trains on one rank (one
    card, no process group) and registers both models; the groups and
    their helpers gone after ``close()``; the phase within 60 s and the
    witness within 45 s.  Printed: the GAT's and the MLP's step ms p50
    at world 2 and 1, the round's seconds, the witness's and the
    control's loss curves' maxima and onsets (their first step past
    1e-5).
26. Image pulls through the daemons' registry proxies and the object
    gateway (``registry_proxy``, ``bench/registry_proxy.run``): phase
    20's composition (the ``ml`` scheduler over phase 2's seeded K1
    scorer, 16 daemons on the native engine at their defaults), each
    daemon fronted by a ``P2PProxy`` whose one rule diverts
    ``blobs/sha256.*`` (upstream Dragonfly's default proxy rule) and an
    ``ObjectGateway`` over one filesystem bucket; an in-process registry
    answering after 20-25 ms serves one image (a manifest, 8 layers of 1
    to 129 MiB, 256 MiB).  (a) 16 clients start together, one a daemon:
    the manifest (direct), then the 8 layers through the proxy; one Range
    request a layer, one unsatisfiable Range, one CONNECT to the
    registry, one to a closed port.  (b) Daemon 0 puts 16 objects of 4
    MiB (the bench's 32 cut for the smoke's time); daemons 1-15 get them all.  Checks: every layer's and object's
    sha256; the proxies' stats summed 136 / 16 / 1 (p2p / direct /
    tunnel); 206 exact, 416, tunnel bytes, 502; the registry's layer
    bytes equal the daemons' back-to-source bytes; daemon 0 uploaded and
    no get of daemons 1-15 went back to source; on the 129 MiB layer a
    client's first byte arrived while its task ran; K1 launches = the
    scheduler's scorer calls > 0, K1 held to plain on the phase's
    flushes; every store native with ``NativePieceServer``; the phase
    within 60 s.  Printed: aggregate MB/s, layer first-byte p50 / p99,
    the registry's byte ratio to the image, daemon 0's share of P2P
    pieces.
27. The secured cluster (``secure_cluster``, ``bench/secure_cluster.run``):
    the manager binary's composition as the cluster CA (``ca_dir``) with a
    32-byte ``token_secret``, ``users_db`` and ``root_password``; root
    signs in over REST and mints a PEER and an OPERATOR personal access
    token; the ``ml`` scheduler over phase 2's seeded K1 scorer requests
    its identity from the manager's CA (``security.auto_issue``, the PEER
    token) and serves gRPC over mutual TLS (``advertise_ip`` 127.0.0.1);
    16 daemons at their defaults request theirs, dial ``grpc://`` over
    mTLS, serve and fetch pieces over mTLS and run an SNI proxy hijacking
    the registry host.  An in-process origin answering after 20-25 ms
    serves a 32 MiB file and an image of 4 layers (1, 4, 16 and 32 MiB;
    the bench's defaults, 128 MiB and a 64 MiB last layer, cut for the
    phase's time) under the hijacked host's ``https://`` URLs.  All 16 daemons download
    the file; 16 clients pull every layer over HTTPS through their
    daemon's SNI proxy, trusting its ``sni-ca.pem``; one client reaches a
    host no daemon hijacks and gets the upstream's bytes unchanged.
    Checks: every identity chains to the manager's CA; an anonymous TLS
    client is refused by a piece server and a channel without a client
    certificate by the scheduler's gRPC port; REST answers 401 without a
    token and to the PEER token on an OPERATOR route, 403 to it on an
    ADMIN route; every sha256; every piece over TLS, none through the
    native fetch loop; no renewer, proxy or server thread left; K1
    launches = the scheduler's scorer calls > 0, K2 and K3 none, K1 held
    to plain on the phase's flushes; the phase within 60 s.  Printed:
    download MB/s and per-download seconds p50 / p99, pull MB/s and layer
    first-byte p50 / p99, the piece servers' TLS handshakes, pieces by
    source, the identity issuance seconds at boot.
28. Manager HA (``manager_failover``, ``bench/manager_failover.run``):
    two manager binaries as child processes (``ha.enable``, a private
    32-byte lease secret, the reference's lease of 10 s and 1 s polls),
    the second booted with ``--replicate-from`` the first; the ``ml``
    scheduler with ``manager_addr`` the pair, its subscription polling
    every 1 s and installing models A and B through K1 (``serve``'s
    ``k1_installs``); a seed daemon and 8
    daemons at their defaults; an origin answering after 20-25 ms with 4
    files of 64 MiB.  Model A activated at the leader, wave 1 (every
    daemon downloads A through ``tools/stress.run_stress``), a preheat of
    B queued with the job worker detached, the leader SIGKILLed once the
    standby applied every row, wave 2 during the outage, the standby
    promoted, model B activated at the survivor, wave 3.  Checks: the
    leader's return code -9; the survivor leads at term >= 2 with
    ``manager_failovers_total`` 1; the standby answered a write 503 with
    ``Retry-After`` before its promotion; the preheat reached SUCCESS at
    the survivor with the seed holding B; every download sha256-equal to
    its file, none failed; ``subscriber.pinned`` never true; K1 launches =
    the scheduler's scorer calls > 0, every flush held to plain on its own
    mirror, the flushes scoring with A's weights and, after B's install,
    B's; no manager child alive and no native server leaked; the phase
    within 60 s.  Printed: replication lag p50 / p99, kill → promotion and
    → first accepted write, each wave's MB/s and latency percentiles,
    activation → installed.
29. The port's own deployment (``deploy``): ``python -m
    dragonfly2_tpu_torch.deploy.run_local`` at its defaults (``--device
    cuda``) as a child process in a session of its own, under a 90 s
    limit: a manager; the trainer and the scheduler on ``--device``
    (``cuda``; the trainer is the one that works on the card, the rule
    scheduler launches nothing); a seed daemon and two daemons; each a
    binary of its own; then the port's e2e loop (back-to-source and P2P,
    preheat, a training round of 2,000 rows on the trainer's device with
    its model activated and installed, a live cluster-config change).
    Each binary counts its own kernel launches and prints them as its
    last line, which ``run_local`` echoes (``cli/common.report_launches``;
    ``{}`` from the manager and the daemons, which never import the
    kernel wrappers).  Checks: exit 0, ``ALL STAGES PASSED``, the six
    services booted, the round trained on ``cuda``, every service's
    launch line read, and 0 launches of K1, K2 and K3 in them: the
    deployment's scheduler ranks by the rules and the e2e trains only
    the MLP.  Printed: each
    service's boot seconds, each stage's seconds, the round's seconds
    and device, each service's launches.  Their sums join the kernels
    line as ``launches_deploy``.

Every comparison of K1 with its plain version on a path's flushes holds
every row finite, the batcher's pad rows included (they read slot 0, a
zeroed row until a host binds there), and saves a flush past the limit
or non-finite under ``OUT/k1_flushes/`` (``bench/k1_replay.save_flush``)
with what it held (``k1_flush_off_plain``); replay one with ``python -m
dragonfly2_tpu_torch.bench.k1_replay FILE``.

The serve-mode phases (16, 17, 20, 21 and 22(b)) run the shard guard
with admission at the config's defaults, as the reference's binary does;
each prints the sheds by priority class its run caused (``sheds``).

The native host engine (``dragonfly2_tpu_torch/native``): phase 1 also
builds ``native/src/native.cpp`` with g++ beside the nvcc builds and
prints ``g++ --version`` (no g++ fails the smoke, naming it); it checks
``native.build_error()`` is None.  The record storage of phases 2 and 12
must write through ``NativeColumnarWriter`` (a tap on
``records.storage._make_columnar_writer``), and ``dfc_rows`` must read
exactly the rows appended.  Phase 14's run A runs the native ingest
engine at the defaults (the adapter native, its ``rows_in`` = the rows
sent); a second wire run on the first half of the same records (8
dispatches) with ``--python-ingest`` prints its records/s through the
service beside run A's and the device's.  Phases 20, 21 and 22(b) run every daemon on the native engine
at the defaults (``engine_ran``: every store native,
``NativePieceServer`` the server, > 0 pieces through ``pf_*``) and check
``native.leaked_servers() == (0, 0)`` after teardown; phase 20 runs a
second arm at the same configuration on the Python store and server with
``native_fetch: false`` and prints both arms side by side.

    python3 chip_smoke.py [--seed 0] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np

from dragonfly2_tpu_torch.bench.k2_ladder import K2_TOL, ladder as k2_ladder
from dragonfly2_tpu_torch.bench.shard_fleet import shed_counts
from dragonfly2_tpu_torch.bench.timing import (
    bound, device_ms, k1_cost, k3_cost,
)

REPO = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()

N_HOSTS = 16384
N_TASKS = 64
HOSTS_PER_TASK = 64        # warm downloads a task (the simulator's 256 cut for the run's time)
PIECES = 16
THREADS = 32
PER_THREAD = 16
SEQUENTIAL = 64
STORE_SLOTS = 65536
SCORE_TOL = 1e-4          # path vs numpy MLPScorer (scores and ties)
K1_TOL = 1e-5             # K1 vs plain, scaled by max(1, max |score|)
# The training phase (BASELINE configs[2], the bench's batch).
GAT_NODES = 100_000
GAT_NEIGHBORS = 16
GAT_EDGES = 1_310_720
GAT_BATCH = 131_072
GAT_EPOCHS = 2
K3_TOL = 1e-5             # K3 vs plain, scaled by max(1, max |sum|)
STEP_LOSS_TOL = 1e-3      # K3 gather step vs index gather step: loss (relative)
STEP_GRAD_TOL = 5e-2      # ... and gradient abs-sum (relative)
STEP_GRAD_L2_TOL = 1e-2   # SAGE steps: ||g - g_k3|| / ||g_k3|| over all leaves
EXPORT_TOL = 3e-2         # exported scorer vs the model's predictions (absolute)
# The streaming phase (BASELINE configs[4] at full width; 1B records cut to 1M).
STREAM_ROWS = 1_048_576
STREAM_WINDOW = (16, 256)   # steps timed: 16..255
STREAM_CKPT = 128           # checkpoint step; the resumed trainer takes 16 more
STREAM_RESUME_STEPS = 16
STREAM_PROFILE = 16
STREAM_HELD = 4096
STREAM_EXPORT_F32_TOL = 1e-4  # exported scorer vs a float32 twin of the module
# The flagship phase: the hop ranker at bench.py's width on phase 6's workload.
HOP_HIDDEN = 1024
HOP_EPOCHS = 6            # 54 steps: after 18 the MAE is at the mean predictor's
HOP_EVENT_STEPS = 10
# The trainer-service phase: DFC1 shards for one --train-once round.
SVC_HOSTS = 16_384
SVC_DOWNLOADS = 65_536
SVC_TOPOLOGY_RECORDS = 16_384
# Rollout serving: the scheduler's warm-up and the rounds of the walk.
ROLL_TASKS = 4
ROLL_HOSTS_PER_TASK = 64
ROLL_PER_ROUND = 16
ROLL_ROUNDS = 12

# Phases 12-13: the scheduler's record and probe half, GraphSAGE on its
# probe graph (BASELINE configs[1]: 1k peers; configs[0]'s 10k download
# records read as 10,000 downloads).
SIM_CLI_DOWNLOADS = 500
SWARM_HOSTS = 1000
SWARM_DOWNLOADS = 10_000
SWARM_TASKS = 64
SWARM_PROBE_ROUNDS = 8
SWARM_TRIALS = 200
SAGE_NEIGHBORS = 16
SAGE_BATCH = 4096
SAGE_EPOCHS = 30
SAGE_TIMED_STEPS = 20
SAGE_PROFILE = 5
# The online graph trainer (configs[4]) and federated FedAvg (configs[3]).
OG_NODES = 100_000
OG_HIDDEN = 1024
OG_BATCH = 131_072
OG_SUPER = 8              # the wire soak's dispatch: 8 steps
OG_DISPATCHES = 16        # run A: 16.8 M records, refreshes after 4, 8, 12
OG_PY_DISPATCHES = 8      # the Python-ingest arm: run A's first half (16 cut for the
                          # smoke's time when phase 29 came)
OG_REFRESH = 4
OG_WARMUP = 50
OG_RESUME_TOTAL = 8       # runs B and C
OG_KILL_AT = 6            # past the refresh at 4
OG_PROFILE = 2
OG_DET_RUNS = 3           # same-state dispatches per determinism probe
FED_SHARDS = 8
FED_HOSTS = 1000
FED_ROWS = 10_000
FED_HELD = 2_000
FED_F32_TOL = 1e-5        # published scorer vs a float32 twin, scaled by max(1, |score|)
PUSH_WARM = 16             # phase 23: warm downloads a task (phase 2's 64 cut for time;
                           # 32 until the deployment phase came)
PUSH_CHILDREN = 16         # ... running children a task, each subscribed to the hub
PUSH_STALL_IDLE_S = 1.0    # ... StallMonitor's max idle (the reference's 10 s cut)
PUSH_STALL_SWEEP_S = 0.25  # ... its sweep interval (2 s cut)
PUSH_STALL_RUN_S = 3.0     # ... how long the monitor runs
QD_EXTRA_PARENTS = 7       # phase 24: more parents a tenant-A task (8 candidates a download)
TR_RANKS = 2               # phase 25: gloo ranks sharing cuda:0
TR_EPOCHS = 6              # ... phase 11's round config cut from 30 epochs (168 GAT steps)
TR_LOSS_RTOL = 1e-3        # ... 2-rank vs one-device losses at every step (relative): the
                           # MLP, and both models of the float32 witness
TR_GAT_LOSS_RTOL = 5e-3    # ... the bf16 GAT's over its first epoch: the mesh trainers' tests'
                           # bound for bf16 losses
TR_F32_LOSS_RTOL = 1e-4    # ... the float32 witness: the MLP at every step, the GAT over its
                           # first epoch (past its loss spike, ~step 43, one device departs
                           # from its own repeat by up to 0.26: the control shows it)
TR_ONSET = 1e-5            # ... a curve's onset: its first step past this (relative)
TR_MAE_BAND = 0.10         # ... the GATs' validation MAE, 2-rank vs one device (relative)
TR_SECONDS = 60.0          # ... the phase's time limit, the float32 witness aside
TR_WITNESS_SECONDS = 45.0  # ... the witness's (three rounds, a helper's start among them)
RP_DAEMONS = 16            # phase 26: daemons, each fronted by a P2PProxy and a gateway
RP_LAYERS_MIB = "1,2,4,8,16,32,64,129"  # ... the image's layers (256 MiB)
RP_OBJECTS = 16            # ... objects daemon 0 puts (32 cut for the smoke's time)
RP_OBJECT_MIB = 4          # ... each object's size
RP_SECONDS = 60.0          # ... the phase's time limit
SC_DAEMONS = 16            # phase 27: daemons, each with an auto-issued mTLS identity
SC_FILE_MIB = 32           # ... the file every daemon downloads (the bench's 128 cut;
                           # 64 until the deployment phase came)
SC_LAYERS_MIB = "1,4,16,32"  # ... the image's layers (the bench's 1,4,16,64 cut)
SC_SECONDS = 60.0          # ... the phase's time limit
MF_DAEMONS = 8             # phase 28: daemons downloading through the manager failover
MF_FILE_MIB = 64           # ... each of files A-D
MF_SECONDS = 60.0          # ... the phase's time limit
DEPLOY_SECONDS = 90.0      # phase 29: run_local's time limit
K1_STRESS_FLUSHES = 2000   # phase 23: seeded stress flushes ...
K1_STRESS_REPEATS = 3      # ... each launched this many times back to back
FED_MEAN_TOL = 1e-6       # the round's aggregate vs a numpy weighted mean
WIRE_DOWNLOADS = 1500     # the swarm's 10,000 cut for the phase's time (3,000 until the
                          # deployment phase came: 39-62 s of downloads on the card's hosts)
WIRE_CLIENTS = 16
WIRE_SEQUENTIAL = 256
WIRE_TRIALS = 40          # parent-choice trials an arm in phases 16-17 (200 cut for the smoke's time)
WIRE_TRAIN_INTERVAL = 115.0  # past the downloads and probes: 75-118 s after the boot on
                             # the card's hosts at 3,000 downloads, 60-90 s at 2,000; a
                             # first round before the probe snapshot makes the phase wait
                             # one more whole interval
WIRE_PROBE_ROUNDS = 4     # the swarm's 8 cut: the snapshot must land before the round
                          # (8 rounds took 60-75 s and missed a 150 s one once)
WIRE_K1_FLUSHES = 64      # flushes whose inputs K1 is held to its plain version on
PS_DAEMONS = 16            # phase 20: daemons in the peer swarm
PS_SIZE_MIB = 256          # ... the origin file (a layer or shard; GBs cut for time)
PH_DAEMONS = 15            # phase 21: normal daemons beside the one seed peer
PH_SIZE_MIB = 256          # ... file A, preheated (as phase 20's file)
PH_COLD_MIB = 64           # ... file B, the cold task
SF_FLEET = {"peers": 128_000, "shards": 4, "ticks": 4, "rounds": 1,  # phase 22(a):
            "announce_rate": 0.5, "download_rate": 0.0005,        # BENCH_SW_r01.json's
            "cache_hosts": 65_536, "seed": 7}                     # configuration
SK_DAEMONS = 16            # phase 22(b): daemons steering across the three shards
SK_FILES = 8               # ... origin files (every shard owns >= 2 by the ring)
SK_SIZE_MIB = 32           # ... each file's size
SK_REFRESH_S = 0.5         # ... the schedulers' dynconfig_refresh_s (10 s cut)
LC_TRAIN_INTERVAL = 45.0  # the Announcer's interval in the lifecycle phase (7 days cut):
                          # its first round lands after the seed scorer's parent choice
LC_DAEMON_INTERVAL = 2.0  # the lifecycle daemon's cycle (30 s cut)
LC_REPORT_INTERVAL = 5.0  # the rollout reporter's cycle (60 s cut)
LC_DOWNLOAD_CAP = 20_000  # downloads the phase may take before the walk ends
LC_TIMEOUT = 360.0        # seconds the walk may take
MD_RANKS = 4              # phase 18(b): gloo ranks on the one card
MD_STEPS_B = 4            # ... flagship steps per mode
MD_PRE_TOL = 1e-5         # sharded vs replicated precompute, scaled by max(1, |x|)
MD_LOSS_RTOL = 1e-3       # node-sharded vs replicated losses (relative)
MD_MAE_TOL = 5e-3         # node-sharded vs replicated validation MAE
MD_SECONDS = 150.0        # the phase's time limit
TQ_TASKS = 64             # phase 19: warm tasks, as phase 2
TQ_WARM = 32              # ... warm downloads a task (phase 2's 64 cut for the phase's time)
TQ_TENANTS = {"t-gold": ("gold", 4.0), "t-silver": ("silver", 2.0),
              "t-bronze": ("bronze", 1.0)}   # tenant: (class, DRR weight)
TQ_RATES = {"off": None, "sampled": 0.1, "full": 1.0}  # tracing sample rate by arm
TQ_ORDER = ("off", "sampled", "full", "full", "sampled", "off")  # mirrored against drift
TQ_SLO = {"name": "eval_flush", "objective": "latency",
          "metric": "scheduler_eval_flush_seconds", "threshold_ms": 5.0, "target": 0.99,
          "fast_window_s": 5.0, "slow_window_s": 60.0}


class SmokeFailure(RuntimeError):
    pass


@contextlib.contextmanager
def tapped(module, name, wrap):
    """``module.name`` replaced by ``wrap(original)`` inside the block, so
    that the smoke reads what a path passes to a function and gets back."""
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def tap_record_writers():
    """Record storage's DFC1 writers from now on: → (seen, restore).
    ``seen["types"]`` holds the writer classes' names, ``seen["rows"]``
    the rows appended through them; ``restore()`` ends the tap."""
    from dragonfly2_tpu_torch.records import storage as record_storage

    seen = {"types": set(), "rows": 0}
    original = record_storage._make_columnar_writer

    def make(path, columns):
        writer = original(path, columns)
        seen["types"].add(type(writer).__name__)
        append = writer.append

        def counted(rows):
            n = append(rows)
            seen["rows"] += int(n)
            return n

        writer.append = counted
        return writer

    record_storage._make_columnar_writer = make

    def restore():
        record_storage._make_columnar_writer = original

    return seen, restore


def check_native_writes(seen, rows_read, where):
    """Phases 2 and 12: the records went through the native DFC1 writer
    and the reader reads back the rows it wrote."""
    check(seen["types"] == {"NativeColumnarWriter"},
          f"{where}: record storage wrote through {sorted(seen['types'])}, not "
          "NativeColumnarWriter")
    check(rows_read == seen["rows"] > 0,
          f"{where}: dfc_rows read {rows_read} rows, the native writer appended {seen['rows']}")


def check_native_daemons(summary, where):
    """Phases 20-22(b) at the defaults: the native engine ran, not its
    fallback, and no native server leaked."""
    engine = summary["engine"]
    check(all(engine["is_native"]), f"{where}: a daemon's store is not native: "
          f"{engine['is_native']}")
    check(engine["piece_servers"] == ["NativePieceServer"],
          f"{where}: piece servers {engine['piece_servers']}")
    check(engine["native_fetch_pieces"] > 0, f"{where}: no piece through the native fetch loop")
    check(engine["leaked_servers"] == [0, 0],
          f"{where}: native.leaked_servers() = {engine['leaked_servers']} at teardown")


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the script
    started (``smoke_s``), so each phase's wall time reads off the log."""
    if "phase" in obj:
        obj = {**obj, "smoke_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def reset_kernel_counts():
    """Zero every kernel wrapper's launch count (K1, K2, K3)."""
    from dragonfly2_tpu_torch.ops import fused_score, segment

    fused_score.reset_launch_counts()
    segment.reset_launch_counts()


def kernel_counts():
    """Every kernel wrapper's launch count since the last reset."""
    from dragonfly2_tpu_torch.ops import launch_counts

    return launch_counts()


def sheds_since(before):
    """Sheds by priority class since ``shed_counts()`` read ``before``:
    the serve-mode phases' schedulers run the shard guard with admission
    at the config's defaults (512 in flight, 50 ms p99)."""
    return {k: v - before.get(k, 0.0) for k, v in shed_counts().items()
            if v - before.get(k, 0.0)}


def weights_from_seed(seed: int, dims=(32, 64, 64, 1)):
    """Seeded serving-MLP weights (scale 0.3 / 0.05)."""
    rng = np.random.default_rng(seed)
    return [
        (
            rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
            rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05,
        )
        for i in range(len(dims) - 1)
    ]


def orders_agree(order, ref_scores, tol: float) -> bool:
    """``order`` (indices, best first) equals the stable descending order
    of ``ref_scores`` up to permutations inside runs of reference scores
    whose adjacent gaps are <= tol."""
    ref_order = np.argsort(-ref_scores, kind="stable")
    sorted_scores = ref_scores[ref_order]
    start = 0
    for i in range(1, len(ref_order) + 1):
        if i == len(ref_order) or sorted_scores[i - 1] - sorted_scores[i] > tol:
            if set(ref_order[start:i].tolist()) != set(order[start:i]):
                return False
            start = i
    return True


# ---------------------------------------------------------------------------
# The serving path
# ---------------------------------------------------------------------------


def warm_tasks(service, cluster, hosts, *, n_tasks, hosts_per_task):
    """Warm ``n_tasks`` tasks with ``hosts_per_task`` downloads each: the
    download sequence of the reference swarm simulator (register → task
    length → every piece from the first scheduled parent or the source →
    finished; the service writes each finished download's record).
    Returns the tasks' URLs."""
    from dragonfly2_tpu_torch.records.synthetic import PIECE_SIZE
    from dragonfly2_tpu_torch.scheduler import ScheduleResultKind

    index = {h.id: i for i, h in enumerate(hosts)}
    urls = [f"https://origin.example.com/blob/{t}" for t in range(n_tasks)]
    for t in range(n_tasks):
        for k in range(hosts_per_task):
            hi = t * hosts_per_task + k
            res = service.register_peer(
                host=hosts[hi], url=urls[t], peer_id=f"warm-{t}-{k}"
            )
            peer = res.peer
            service.set_task_info(peer, PIECES * PIECE_SIZE, PIECES, PIECE_SIZE)
            sched = res.schedule
            parent = (
                sched.parents[0]
                if sched is not None and sched.kind is ScheduleResultKind.PARENTS
                else None
            )
            for n in range(PIECES):
                if parent is None:
                    bw = float(cluster.down_cap[hi]) * 0.5
                    pid = ""
                else:
                    bw = max(cluster.bandwidth(index[parent.host.id], hi, noise=False), 1e3)
                    pid = parent.id
                service.report_piece_finished(
                    peer, n, parent_id=pid, length=PIECE_SIZE,
                    cost_ns=int(PIECE_SIZE / bw * 1e9),
                )
            service.report_peer_finished(peer)
    return urls


def serve_requests(service, hosts, urls, *, hosts_per_task, threads, per_thread,
                   first=0, tenants=()):
    """``threads × per_thread`` concurrent registrations, requests
    ``first`` on; request q registers a host of the NEXT task's group
    into task q % n_tasks, so the host has no peer there yet.  With
    ``tenants``, thread t registers as ``tenants[t % len(tenants)]``.  Returns
    the records of every ranked candidate set and the phase's timings:
    register_peer per request, evaluate_parents per ranked set, and the
    scorer call per flush (host time, the kernel launch included)."""
    ev = service.scheduling.evaluator
    scorer = ev._scorer
    n_tasks = len(urls)
    records = {}
    evaluate_s = []
    flush_s = []
    rec_mu = threading.Lock()
    evaluate = ev.evaluate_parents
    score = scorer.score

    def recording(parents, child, total):
        t0 = time.perf_counter()
        ranked = evaluate(parents, child, total)
        dt = time.perf_counter() - t0
        with rec_mu:
            records[child.id] = (list(parents), child, total, ranked)
            evaluate_s.append(dt)
        return ranked

    def timed_score(*args, **kwargs):
        t0 = time.perf_counter()
        out = score(*args, **kwargs)
        dt = time.perf_counter() - t0
        with rec_mu:
            flush_s.append(dt)
        return out

    n_req = threads * per_thread
    plan = [
        (q % n_tasks, ((q % n_tasks + 1) % n_tasks) * hosts_per_task + q // n_tasks)
        for q in range(first, first + n_req)
    ]
    lat = [0.0] * n_req
    kinds = [None] * n_req
    errors = []
    barrier = threading.Barrier(threads + 1)

    def worker(t: int) -> None:
        tenant = tenants[t % len(tenants)] if tenants else ""
        try:
            barrier.wait()
            for i in range(t * per_thread, (t + 1) * per_thread):
                task_i, hi = plan[i]
                t0 = time.perf_counter()
                res = service.register_peer(
                    host=hosts[hi], url=urls[task_i], peer_id=f"req-{first + i}",
                    tenant=tenant,
                )
                lat[i] = time.perf_counter() - t0
                kinds[i] = res.schedule.kind.name if res.schedule else "NONE"
        except Exception as exc:  # re-raised on the main thread after join
            errors.append(exc)

    ev.evaluate_parents = recording
    scorer.score = timed_score
    try:
        pool = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
        for th in pool:
            th.start()
        barrier.wait()
        t0 = time.perf_counter()
        for th in pool:
            th.join()
        wall = time.perf_counter() - t0
    finally:
        del ev.evaluate_parents
        del scorer.score
    if errors:
        raise errors[0]
    counts = {}
    for k in kinds:
        counts[k] = counts.get(k, 0) + 1
    timing = {"wall": wall, "register": lat, "evaluate": evaluate_s, "flush": flush_s}
    return list(records.values()), timing, counts


def summarize(timing, n_req):
    """Per-layer medians (ms) and the end-to-end numbers of a phase."""
    ms = {k: sorted(x * 1e3 for x in timing[k]) for k in ("register", "evaluate", "flush")}
    return {
        "requests": n_req,
        "announce_rate_per_s": n_req / timing["wall"],
        "register_p50_ms": float(np.percentile(ms["register"], 50)),
        "register_p99_ms": float(np.percentile(ms["register"], 99)),
        "evaluate_p50_ms": float(np.percentile(ms["evaluate"], 50)) if ms["evaluate"] else None,
        "flush_p50_ms": float(np.percentile(ms["flush"], 50)) if ms["flush"] else None,
        "flushes": len(ms["flush"]),
    }


def rule_arm(ev, records, device):
    """K2 over the rule components of each recorded candidate set,
    against the float64 weighted sum of the same components."""
    from dragonfly2_tpu_torch.ops.fused_score import RULE_COMPONENT_WEIGHTS, rule_weighted_sum

    w = np.asarray(RULE_COMPONENT_WEIGHTS, np.float64)
    comps_all = []
    err = 0.0
    for parents, child, total, _ in records:
        comps = np.stack(ev._component_arrays(parents, child, total), axis=1)
        got = rule_weighted_sum(comps, device=device)
        want = comps @ w
        err = max(err, float(np.max(np.abs(got - want))))
        comps_all.append(comps.astype(np.float32))
    return np.concatenate(comps_all), err


def verify_rankings(ev, scorer, ref, records):
    """Frozen-state re-rank of every recorded candidate set: the path's
    ranking and K1's scores against the numpy scorer."""
    worst = 0.0
    inputs = []
    for parents, child, total, ranked in records:
        check(sorted(p.id for p in ranked) == sorted(p.id for p in parents),
              "a ranking is not a permutation of its candidates")
        feats, _, _ = ev._featurize_batch(parents, child)
        want = ref.score(feats)
        edge, src, cslot, _, _ = ev._featurize_slots(parents, child)
        dst = np.full(len(parents), cslot, dtype=np.int64)
        got = scorer.score(edge, src_buckets=src, dst_buckets=dst)
        worst = max(worst, float(np.max(np.abs(got - want))))
        pos = {p.id: i for i, p in enumerate(parents)}
        order = [pos[p.id] for p in ev.evaluate_parents(parents, child, total)]
        check(orders_agree(order, want, SCORE_TOL),
              f"path ranking differs from the numpy MLPScorer for {child.id}")
        inputs.append((edge, src, dst))
    check(worst <= SCORE_TOL, f"K1 scores differ from MLPScorer by {worst}")
    return worst, inputs


# ---------------------------------------------------------------------------
# Kernels: comparison and timing
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# The training path: the GAT ranker with K3
# ---------------------------------------------------------------------------


def gat_workload(seed: int):
    """configs[2]'s graph and download edges, made from ``seed``."""
    from dragonfly2_tpu_torch.models.gnn import build_neighbor_table
    from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster

    n = GAT_NODES
    cluster = SyntheticCluster(num_hosts=n, seed=seed)
    src, dst, rtt = cluster.probe_edges(density=GAT_NEIGHBORS / (n - 1), seed=seed)
    table = build_neighbor_table(n, src, dst, rtt / 1e9, max_neighbors=GAT_NEIGHBORS)
    rng = np.random.default_rng(seed)
    e_src = rng.integers(0, n, GAT_EDGES)
    e_dst = (e_src + rng.integers(1, n, GAT_EDGES)) % n
    target = np.log1p(cluster._bandwidth_vec(e_src, e_dst)).astype(np.float32)
    return {
        "node_feats": cluster._host_feature_matrix(), "table": table,
        "src": e_src, "dst": e_dst, "target": target, "probe_edges": int(len(src)),
    }


def step_equivalence(torch, state, work, gather_cfg, dev, seed):
    """One train step's loss and gradients from the trained state on the
    first batch, with the K3 gather and with the index gather's own
    backward; dropout from one generator state in both."""
    from dragonfly2_tpu_torch.models.gnn import GATRanker
    from dragonfly2_tpu_torch.trainer.train import epoch_batches, split_edges

    _, train_idx = split_edges(GAT_EDGES, seed)
    idx = next(epoch_batches(train_idx, GAT_BATCH, seed, 0))
    nf = torch.from_numpy(work["node_feats"]).to(dev)
    table = work["table"].to(dev)
    src = torch.from_numpy(work["src"][idx]).to(dev)
    dst = torch.from_numpy(work["dst"][idx]).to(dev)
    target = torch.from_numpy(work["target"][idx]).to(dev)
    plain = GATRanker(
        dataclasses.replace(gather_cfg, gather_fn=None),
        num_nodes=GAT_NODES, in_dim=work["node_feats"].shape[1],
    ).to(dev)
    plain.load_state_dict(state.model.state_dict())
    res = gather_equivalence(torch, state, {"k3": state.model, "index": plain},
                             (nf, table, src, dst, target, None), dev)["index"]
    return {"loss_k3": res["loss_k3"], "loss_index": res["loss"],
            **{k: res[k] for k in ("loss_rel", "grad_abs_sum_rel", "grad_l2_rel")}}


def k3_checks(torch, dev, plan, seed):
    """K3 against its plain version: the path's two bf16 shapes over the
    real bucketed layout, one f32 exact shape, zero edges, an empty node
    block.  Returns the errors and the path-shape inputs."""
    from dragonfly2_tpu_torch.ops.segment import _segment_sum_plain, build_plan, segment_sum_bucketed

    rng = np.random.default_rng(seed)
    rows = GAT_NODES * GAT_NEIGHBORS
    cases = {}
    inputs = {}
    for name, d, dtype, exact in (("bf16_d44", 44, torch.bfloat16, False),
                                  ("bf16_d128", 128, torch.bfloat16, False),
                                  ("f32_exact_d44", 44, torch.float32, True)):
        vals = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32)).to(dtype).to(dev)
        got = segment_sum_bucketed(vals, plan, exact=exact)
        torch.cuda.synchronize()
        want = _segment_sum_plain(vals, plan, exact=exact, presorted=False)
        cases[name] = (got, want)
        if dtype == torch.bfloat16:
            inputs[d] = vals
    zero_plan = build_plan(np.zeros(0, np.int64), GAT_NODES, device=dev)
    zeros = torch.zeros((zero_plan.e_pad, 44), dtype=torch.bfloat16, device=dev)
    cases["zero_edges"] = (segment_sum_bucketed(zeros, zero_plan, exact=False, presorted=True),
                           _segment_sum_plain(zeros, zero_plan, exact=False, presorted=True))
    hole_ids = np.array([5, 5, 6, 200, 520, 521])     # node block 1 (256..511) empty
    hole_plan = build_plan(hole_ids, 600, device=dev)
    hole = torch.from_numpy(rng.standard_normal((6, 44), dtype=np.float32)).to(dev)
    cases["empty_node_block"] = (segment_sum_bucketed(hole, hole_plan, exact=False),
                                 _segment_sum_plain(hole, hole_plan, exact=False, presorted=False))
    torch.cuda.synchronize()
    errs, scales = {}, {}
    for name, (got, want) in cases.items():
        check(got.shape == want.shape and got.dtype == torch.float32, f"K3 {name}: shape/dtype")
        check(bool(torch.isfinite(got).all()), f"K3 {name}: non-finite")
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        errs[name], scales[name] = err, scale
        check(err <= K3_TOL * scale, f"K3 off its plain version by {err} ({name}, scale {scale})")
    check(not bool(cases["zero_edges"][0].any()), "K3 with zero edges is not all zero")
    check(not bool(cases["empty_node_block"][0][256:512].any()), "K3 empty node block not zero")
    return errs, scales, inputs


def kernel_device_ms(torch, fn, names, calls=10):
    """Device ms per ``fn()`` of each kernel whose name holds one of
    ``names``, from ``torch.profiler``: the split of one wrapper call into
    its launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in names}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        for name in names:
            if name in ev.key:
                out[name] += dev_us / 1e3 / calls
    return out


def profile_steps(torch, step, steps, top=15):
    """``steps`` calls of ``step()`` (after one unprofiled call) under
    ``torch.profiler``: the kernels with the most device time and the
    device's idle share of the steps' wall time (one stream, so kernel
    times do not overlap); on the host, the operators and runtime calls
    with the most self time and their sum (the rest of the wall time is
    Python and numpy outside any operator)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows, host = [], []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            if ev.self_cpu_time_total > 0:
                host.append((ev.self_cpu_time_total / 1e3 / steps, ev.count // steps, ev.key))
            continue
        # Kernels only: an operator's own entry repeats its kernels' time.
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / steps, ev.count // steps, ev.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    device_ms_step = sum(r[0] for r in rows)
    return {
        "steps": steps, "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms_step,
        "device_idle_share": 1.0 - device_ms_step / wall_ms,
        "kernels_per_step": sum(r[1] for r in rows),
        "top": [{"ms_per_step": ms, "calls_per_step": n, "name": name[:120]}
                for ms, n, name in rows[:top]],
        "host_ops_ms_per_step": sum(r[0] for r in host),
        "host_calls_per_step": sum(r[1] for r in host),
        "host_top": [{"ms_per_step": ms, "calls_per_step": n, "name": name[:80]}
                     for ms, n, name in host[:10]],
    }


def train_phase(torch, dev, seed):
    """Phase 6: train the GAT ranker on the card, check it, export it,
    hold and time K3.  Returns (K3's kernels entry, summary, workload)."""
    from dragonfly2_tpu_torch.models.gnn import GNNConfig
    from dragonfly2_tpu_torch.ops import fused_score, segment
    from dragonfly2_tpu_torch.ops.segment import (
        _segment_sum_plain, make_neighbor_gather, segment_sum_bucketed,
    )
    from dragonfly2_tpu_torch.trainer.export import (
        export_gnn_scorer, gnn_scorer_to_bytes, load_scorer,
    )
    from dragonfly2_tpu_torch.trainer.train import (
        TrainConfig, _graph_train_step, epoch_batches, split_edges, train_gat_ranker,
    )

    t0 = time.perf_counter()
    work = gat_workload(seed)
    gather = make_neighbor_gather(work["table"].indices, GAT_NODES, device=dev)
    prep_s = time.perf_counter() - t0
    mcfg = GNNConfig(gather_fn=gather)
    tcfg = TrainConfig(epochs=GAT_EPOCHS, warmup_steps=2, log_every=1, seed=seed)

    reset_kernel_counts()
    t1 = time.perf_counter()
    state, metrics, history = train_gat_ranker(
        work["node_feats"], work["table"], work["src"], work["dst"], work["target"],
        model_config=mcfg, config=tcfg, device=dev, batch_size=GAT_BATCH,
    )
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    k3_launches = segment.LAUNCHES["segment_sum"]
    steps = state.step
    losses = [h["loss"] for h in history]
    elapsed = [h["elapsed_s"] for h in history]
    step_ms = [(b - a) * 1e3 for a, b in zip(elapsed[1:], elapsed[2:])]   # steps 3..
    step_p50 = float(np.median(step_ms))
    emit({"phase": "training", "prep_seconds": prep_s, "train_seconds": train_s,
          "probe_edges": work["probe_edges"], "steps": steps, "k3_launches": k3_launches,
          "losses": losses, "metrics": metrics.to_dict(), "step_ms_p50": step_p50,
          "step_ms_steps_3_on": step_ms, "records_per_s": GAT_BATCH / (step_p50 / 1e3),
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})

    check(steps == GAT_EPOCHS * ((GAT_EDGES - GAT_EDGES // 10) // GAT_BATCH),
          f"{steps} train steps")
    check(k3_launches == 2 * steps, f"K3 launches {k3_launches} != 2 x {steps} steps")
    check(fused_score.LAUNCHES["fused_gather_mlp_score"] == 0, "K1 launched by training")
    check(len(losses) == steps and all(np.isfinite(losses)), "a non-finite or missing loss")
    check(float(np.mean(losses[-3:])) < losses[0],
          f"loss did not fall: first {losses[0]}, last 3 {losses[-3:]}")
    check(all(np.isfinite(list(metrics.to_dict().values()))), "non-finite validation metrics")

    equiv = step_equivalence(torch, state, work, mcfg, dev, seed)
    check(equiv["loss_rel"] <= STEP_LOSS_TOL, f"K3 step loss off the index step: {equiv}")
    check(equiv["grad_abs_sum_rel"] <= STEP_GRAD_TOL, f"K3 step gradients off: {equiv}")

    scorer = load_scorer(gnn_scorer_to_bytes(export_gnn_scorer(
        state.model, work["node_feats"], work["table"], np.arange(GAT_NODES))))
    val_idx = state.val_idx
    scores = scorer.score(None, src_buckets=work["src"][val_idx], dst_buckets=work["dst"][val_idx])
    export_err = float(np.max(np.abs(scores - state.val_pred)))
    check(scores.shape == val_idx.shape and bool(np.isfinite(scores).all()), "exported scores")
    check(export_err <= EXPORT_TOL, f"exported scorer off the model by {export_err}")
    emit({"phase": "training_checks", "step_equivalence": equiv,
          "export_max_abs_err": export_err, "export_tol": EXPORT_TOL})

    # K3 against its plain version, then its times at the path's shapes.
    plan = gather.plan
    errs, scales, inputs = k3_checks(torch, dev, plan, seed)
    chunks = {k: v.cpu().numpy() for k, v in plan.chunks.items()}
    on_split = chunks["chunk_slot"] >= 0
    chunk_edges = chunks["chunk_hi"] - chunks["chunk_lo"]
    flat_ids = gather.flat_indices
    per_shape = {}
    for d, vals in inputs.items():
        vals32 = vals.float()
        ms = device_ms(lambda: segment_sum_bucketed(vals, plan, exact=False))
        plain_ms = device_ms(lambda: _segment_sum_plain(vals, plan, exact=False,
                                                               presorted=False), samples=5, reps=2)
        lib_ms = device_ms(lambda: torch.zeros((GAT_NODES, d), device=dev).index_add_(
            0, flat_ids, vals32), samples=10, reps=5)
        bound_ms, bound_by = bound(*k3_cost(plan, d, 2))
        # The two passes' device time (the combine pass is launched as a
        # dependent of the first, so its span includes its wait).
        passes = kernel_device_ms(
            torch, lambda: segment_sum_bucketed(vals, plan, exact=False),
            ("segment_sum_chunks", "segment_sum_combine"))
        per_shape[d] = {"ms": ms, "plain_ms": plain_ms, "index_add_ms": lib_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "share_of_bound": bound_ms / ms, "pass_ms": passes}
        del vals32
    k3_step_ms = sum(v["ms"] for v in per_shape.values())
    emit({"phase": "k3", "max_abs_err": errs, "max_abs_want": scales, "tol_scaled": K3_TOL,
          "shapes": per_shape,
          "path_launches": k3_launches, "launches_per_step": 2,
          "check_and_timing_launches": segment.LAUNCHES["segment_sum"] - k3_launches,
          "k3_ms_per_step": k3_step_ms, "step_ms_p50": step_p50,
          "k3_share_of_step": k3_step_ms / step_p50,
          "rows": GAT_NODES * GAT_NEIGHBORS, "e_pad": plan.e_pad,
          "padded_slots": int((work["table"].mask == 0).sum()),
          "chunks": int(chunk_edges.size), "chunk_edges_mean": float(chunk_edges.mean()),
          "split_segments": int(chunks["long_seg"].size), "partials": plan.n_partials,
          "split_segment_edges": int(chunk_edges[on_split].sum()),
          "edge_blocks": plan.e_pad // plan.edge_block,
          "node_block_0_edge_blocks": int((plan.block_node == 0).sum())})

    def mean(key):
        return sum(v[key] for v in per_shape.values()) / len(per_shape)

    entry = {"name": "segment_sum", "route": "cuda",
             "source": "dragonfly2_tpu_torch/csrc/segment_sum.cu",
             "replaces": "dragonfly2_tpu/ops/pallas_segment.py:98",
             "launches": k3_launches, "max_abs_err": max(errs.values()),
             "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
             "bound_by": "bytes", "library_ms": mean("index_add_ms"),
             "share_of_bound": mean("bound_ms") / mean("ms"),
             "ms_d44": per_shape[44]["ms"], "ms_d128": per_shape[128]["ms"]}
    summary = {"steps": steps, "step_ms_p50": step_p50, "k3": per_shape,
               "metrics": metrics.to_dict(), "step_equivalence": equiv, "losses": losses}
    # Three more steps on the first batch, profiled.
    _, train_idx = split_edges(GAT_EDGES, seed)
    idx = next(epoch_batches(train_idx, GAT_BATCH, seed, 0))
    args = (
        torch.from_numpy(work["node_feats"]).to(dev), work["table"].to(dev),
        torch.from_numpy(work["src"][idx]).to(dev), torch.from_numpy(work["dst"][idx]).to(dev),
        torch.from_numpy(work["target"][idx]).to(dev), None,
    )
    summary["profile"] = profile_steps(torch, lambda: _graph_train_step(state, *args), steps=3)
    emit({"phase": "training_profile", **summary["profile"]})
    return entry, summary, work


# ---------------------------------------------------------------------------
# The flagship: the hop ranker at full width
# ---------------------------------------------------------------------------


def mean_predictor_mae(target, val_idx, train_idx):
    """Validation MAE of predicting the training split's mean target."""
    return float(np.mean(np.abs(target[val_idx] - target[train_idx].mean())))


def step_p50_of(history):
    """Median ms between steps 3.. of a history (elapsed after each step)."""
    elapsed = [h["elapsed_s"] for h in history]
    return float(np.median([(b - a) * 1e3 for a, b in zip(elapsed[1:], elapsed[2:])]))


def hop_phase(torch, dev, seed, work, gat_metrics):
    """Phase 10: precompute, train, export and time the hop ranker on
    phase 6's workload.  Returns its summary."""
    from dragonfly2_tpu_torch.bench.flagship import (
        PEAK_BF16_FLOPS, hop_train_flops, mfu, step_window,
    )
    from dragonfly2_tpu_torch.models.hop import (
        HopConfig, hop_feature_dim, precompute_hop_features,
    )
    from dragonfly2_tpu_torch.trainer.export import (
        export_gnn_scorer, gnn_scorer_to_bytes, load_scorer,
    )
    from dragonfly2_tpu_torch.trainer.train import (
        TrainConfig, _graph_train_step, epoch_batches, split_edges, train_hop_ranker,
    )

    mcfg = HopConfig(hidden=HOP_HIDDEN)
    table = work["table"].to(dev)
    nf = torch.from_numpy(work["node_feats"]).to(dev)
    precompute_ms = []
    for _ in range(2):                       # the first call, then a warm one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hop = precompute_hop_features(nf, table, hops=mcfg.hops)
        torch.cuda.synchronize()
        precompute_ms.append((time.perf_counter() - t0) * 1e3)
    want_shape = (GAT_NODES, hop_feature_dim(work["node_feats"].shape[1], mcfg.hops))
    check(tuple(hop.shape) == want_shape and bool(torch.isfinite(hop).all()),
          f"hop features {tuple(hop.shape)}")

    def train(epochs):
        """train_hop_ranker on the precomputed features; launch counts
        zeroed just before and read just after."""
        tcfg = TrainConfig(epochs=epochs, warmup_steps=2, log_every=1, seed=seed)
        reset_kernel_counts()
        out = train_hop_ranker(
            work["node_feats"], work["table"], work["src"], work["dst"], work["target"],
            model_config=mcfg, config=tcfg, device=dev, batch_size=GAT_BATCH, hop_feats=hop,
        )
        torch.cuda.synchronize()
        return out, kernel_counts()

    # Phase 6's depth first, for its validation metrics beside the GAT's.
    (_, metrics_18, history_18), launches_18 = train(GAT_EPOCHS)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    (state, metrics, history), launches = train(HOP_EPOCHS)
    train_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in history]
    elapsed = [h["elapsed_s"] for h in history]
    step_ms = [(b - a) * 1e3 for a, b in zip(elapsed[1:], elapsed[2:])]   # steps 3..
    step_p50 = float(np.median(step_ms))
    val_idx, train_idx = split_edges(GAT_EDGES, seed)
    mean_mae = mean_predictor_mae(work["target"], val_idx, train_idx)

    scorer = load_scorer(gnn_scorer_to_bytes(export_gnn_scorer(
        state.model, hop, work["table"], np.arange(GAT_NODES))))
    scores = scorer.score(None, src_buckets=work["src"][val_idx],
                          dst_buckets=work["dst"][val_idx])
    export_scaled = float(np.max(np.abs(scores - state.val_pred)
                                 / np.maximum(1.0, np.abs(state.val_pred))))

    # The step on the device's clock: 10 more steps on the first batch,
    # no host sync inside the window.
    idx = next(epoch_batches(train_idx, GAT_BATCH, seed, 0))
    args = (hop, table, torch.from_numpy(work["src"][idx]).to(dev),
            torch.from_numpy(work["dst"][idx]).to(dev),
            torch.from_numpy(work["target"][idx]).to(dev), None)
    _graph_train_step(state, *args)
    event_ms, _, _ = step_window(lambda: _graph_train_step(state, *args), HOP_EVENT_STEPS)
    flops = hop_train_flops(mcfg, work["node_feats"].shape[1], GAT_BATCH)
    profile = profile_steps(torch, lambda: _graph_train_step(state, *args), steps=3)

    summary = {
        "precompute_ms": precompute_ms, "hop_dim": int(hop.shape[1]),
        "train_seconds": train_s, "steps": len(losses),
        "hidden": mcfg.hidden, "dtype": str(mcfg.dtype), "dropout": mcfg.dropout,
        "losses": losses, "metrics": metrics.to_dict(),
        "metrics_after_18_steps": metrics_18.to_dict(), "gat_metrics": gat_metrics,
        "mean_predictor_mae": mean_mae,
        "step_ms_p50": step_p50, "step_ms_steps_3_on": step_ms,
        "records_per_s": GAT_BATCH / (step_p50 / 1e3),
        "step_ms_events": event_ms, "records_per_s_events": GAT_BATCH / (event_ms / 1e3),
        "flops_per_step": flops, "peak_bf16_flops": PEAK_BF16_FLOPS,
        "mfu": mfu(flops, event_ms), "mfu_p50": mfu(flops, step_p50),
        "peak_memory_gib": peak / 2**30, "kernel_launches": launches,
        "kernel_launches_18_steps": launches_18,
        "losses_18": [h["loss"] for h in history_18],
        "step_ms_p50_18": step_p50_of(history_18),
        "export_max_scaled_err": export_scaled, "export_tol_scaled": EXPORT_TOL,
    }
    emit({"phase": "hop", **summary})
    emit({"phase": "hop_profile", **profile})
    check(len(losses) == HOP_EPOCHS * ((GAT_EDGES - GAT_EDGES // 10) // GAT_BATCH),
          f"{len(losses)} hop train steps")
    check(all(np.isfinite(losses)), "a non-finite hop loss")
    check(float(np.mean(losses[-3:])) < losses[0],
          f"hop loss did not fall: first {losses[0]}, last 3 {losses[-3:]}")
    check(metrics.mae < mean_mae,
          f"hop validation MAE {metrics.mae} not below the mean predictor's {mean_mae}")
    check(bool(np.isfinite(scores).all()) and export_scaled <= EXPORT_TOL,
          f"hop export off the model by {export_scaled} (scaled)")
    check(len(history_18) == GAT_EPOCHS * ((GAT_EDGES - GAT_EDGES // 10) // GAT_BATCH)
          and all(np.isfinite([h["loss"] for h in history_18])), "hop 18-step run")
    check(metrics_18.mae <= mean_mae,
          f"hop validation MAE after 18 steps {metrics_18.mae} above the mean "
          f"predictor's {mean_mae}")
    check(not any(launches.values()) and not any(launches_18.values()),
          f"a kernel launched on the hop path: {launches}, {launches_18}")
    summary["profile"] = profile
    return summary


# ---------------------------------------------------------------------------
# The trainer service: cli/trainer --train-once on the card
# ---------------------------------------------------------------------------


def write_service_shards(directory, seed):
    """DFC1 download and topology shards from one synthetic cluster."""
    from dragonfly2_tpu_torch.records.columnar import ColumnarWriter
    from dragonfly2_tpu_torch.records.features import (
        DOWNLOAD_COLUMNS, TOPO_COLUMNS, topology_to_rows,
    )
    from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster

    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    cluster = SyntheticCluster(num_hosts=SVC_HOSTS, seed=seed)
    with ColumnarWriter(os.path.join(directory, "download_0.dfc"), DOWNLOAD_COLUMNS) as w:
        w.append(cluster.generate_feature_rows(SVC_DOWNLOADS, seed=seed))
    topo_rows = 0
    with ColumnarWriter(os.path.join(directory, "networktopology_0.dfc"), TOPO_COLUMNS) as w:
        for record in cluster.generate_topology_records(SVC_TOPOLOGY_RECORDS):
            topo_rows += w.append(topology_to_rows(record, now_ns=record.created_at))
    return topo_rows


def trainer_service_phase(torch, dev, seed, out_dir):
    """Phase 11: one --train-once round of the trainer binary on the card,
    then the service's GAT branch on the same shards.  Returns its
    summary (with the GAT run's K3 launches)."""
    from dragonfly2_tpu_torch.cli import trainer as trainer_cli
    from dragonfly2_tpu_torch.manager.registry import ModelRegistry
    from dragonfly2_tpu_torch.ops import segment
    from dragonfly2_tpu_torch.trainer.export import GNNScorer, MLPScorer, load_scorer
    from dragonfly2_tpu_torch.trainer.service import (
        GNN_MODEL_NAME, MLP_MODEL_NAME, TrainerService,
    )
    from dragonfly2_tpu_torch.ops.segment import _segment_sum_plain
    from dragonfly2_tpu_torch.trainer import train as train_mod
    from dragonfly2_tpu_torch.config import TrainerConfigFile, load_config
    from dragonfly2_tpu_torch.trainer.train import split_edges

    shard_dir = os.path.join(out_dir, "trainer_shards")
    t0 = time.perf_counter()
    topo_rows = write_service_shards(shard_dir, seed)
    write_s = time.perf_counter() - t0

    registry = ModelRegistry()
    reset_kernel_counts()
    t1 = time.perf_counter()
    rc = trainer_cli.run(["--train-once", shard_dir, "--device", "cuda"], registry=registry)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t1
    launches = kernel_counts()
    models = {m.name: m for m in registry.list()}
    loaded = {name: load_scorer(registry.load_artifact(m)) for name, m in models.items()}
    check(rc == 0, f"trainer --train-once exited {rc}")
    check(sorted(models) == sorted([MLP_MODEL_NAME, GNN_MODEL_NAME]),
          f"registered models: {sorted(models)}")
    check(isinstance(loaded[MLP_MODEL_NAME], MLPScorer)
          and isinstance(loaded[GNN_MODEL_NAME], GNNScorer), "artifact types")
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((64, 32)).astype(np.float32)
    gnn = loaded[GNN_MODEL_NAME]
    b = gnn.buckets[rng.integers(0, len(gnn.buckets), 64)]
    check(bool(np.isfinite(loaded[MLP_MODEL_NAME].score(feats)).all())
          and bool(np.isfinite(gnn.score(None, src_buckets=b, dst_buckets=b[::-1])).all()),
          "registered artifacts score non-finite values")
    check(not any(launches.values()), f"a kernel launched on the trainer round: {launches}")

    # The service's GAT branch on the same shards: K3 is its gather's
    # backward.  Taps keep the run's first K3 input (the gather's
    # backward input and its plan) and its trained state and data.
    seen = {}

    def keep_first_k3(fn):
        def wrapped(values, plan, **kw):
            seen.setdefault("k3", (values.detach().clone(), plan, kw))
            return fn(values, plan, **kw)
        return wrapped

    def keep_run(fn):
        def wrapped(node_feats, table, src, dst, target, **kw):
            out = fn(node_feats, table, src, dst, target, **kw)
            seen["run"] = (out[0], target, kw)
            return out
        return wrapped

    def keep_gather(fn):
        def wrapped(*a, **kw):
            gather = fn(*a, **kw)
            seen.setdefault("gather", gather)
            return gather
        return wrapped

    # The --train-once round's config: under TrainConfig(epochs=2) (lr
    # 3e-4, 100 warm-up steps) the 56 steps end inside the warm-up, at the
    # mean predictor's MAE, in the JAX package as in the port.
    gat_config = trainer_cli.train_config(load_config(TrainerConfigFile, env=False))
    reset_kernel_counts()
    t2 = time.perf_counter()
    with tapped(segment, "segment_sum_bucketed", keep_first_k3), \
            tapped(segment, "make_neighbor_gather", keep_gather), \
            tapped(train_mod, "train_gat_ranker", keep_run):
        svc = TrainerService(ModelRegistry(), gnn_model="gat",
                             train_config=gat_config, device=dev)
        session = svc.open_train_stream(ip="127.0.0.1", hostname="chip-smoke",
                                        scheduler_id="s")
        session.send_download_shard(os.path.join(shard_dir, "download_0.dfc"))
        session.send_network_topology_shard(os.path.join(shard_dir, "networktopology_0.dfc"))
        gat_run = svc.runs[session.close_and_train()]
        torch.cuda.synchronize()
    gat_s = time.perf_counter() - t2
    gat_launches = kernel_counts()
    check(gat_run.error is None and GNN_MODEL_NAME in gat_run.metrics and "run" in seen
          and "k3" in seen and "gather" in seen, f"service gat run: {gat_run.error}")

    # K3 against its plain version at this path's shapes, on the tapped
    # input; these launches come after the counts were read.
    state, target, run_kw = seen["run"]
    values, plan, k3_kw = seen["k3"]
    got = segment.segment_sum_bucketed(values, plan, **k3_kw)
    torch.cuda.synchronize()
    want = _segment_sum_plain(values, plan, exact=k3_kw["exact"],
                              presorted=k3_kw.get("presorted", False))
    k3_err = float((got - want).abs().max())
    # Held relative to the sums themselves: these gradients are far below
    # 1, where phase 6's floor of 1 would let a wrong sum through.
    k3_max = float(want.abs().max())
    k3_nonzero = int((want != 0).any(dim=1).sum())
    k3_ms = device_ms(lambda: segment.segment_sum_bucketed(values, plan, **k3_kw))
    k3_plain_ms = device_ms(lambda: _segment_sum_plain(
        values, plan, exact=k3_kw["exact"], presorted=k3_kw.get("presorted", False)))
    k3_bound_ms, _ = bound(*k3_cost(plan, values.shape[1], values.element_size()))
    # The library call for the same sums: index_add_ of the gather's
    # backward input, in f32, into the segments.
    vals32 = values.float()
    k3_lib_ms = device_ms(lambda: torch.zeros((plan.num_segments, values.shape[1]),
                                              device=dev).index_add_(
        0, seen["gather"].flat_indices, vals32), samples=10, reps=5)
    steps = state.step
    layers = run_kw["model_config"].num_layers
    val_idx, train_idx = split_edges(len(target), run_kw["config"].seed)
    gat_mean_mae = mean_predictor_mae(target, val_idx, train_idx)
    gat_metrics = gat_run.metrics[GNN_MODEL_NAME]
    summary = {
        "write_seconds": write_s, "download_rows": SVC_DOWNLOADS, "topology_rows": topo_rows,
        "hosts": SVC_HOSTS, "round_seconds": round_s, "rc": rc,
        "models": {name: {"type": m.type, "version": m.version, "evaluation": m.evaluation}
                   for name, m in models.items()},
        "gnn_nodes": int(len(gnn.buckets)), "kernel_launches": launches,
        "gat_epochs": gat_config.epochs, "gat_seconds": gat_s, "gat_steps": steps,
        "gat_layers": layers, "gat_error": gat_run.error,
        "gat_metrics": {k: v.to_dict() for k, v in gat_run.metrics.items()},
        "gat_mean_predictor_mae": gat_mean_mae,
        "gat_kernel_launches": gat_launches,
        "k3": {"rows": int(values.shape[0]), "d": int(values.shape[1]),
               "dtype": str(values.dtype), "segments": plan.num_segments,
               "chunks": int(plan.chunks["chunk_lo"].numel()), "partials": plan.n_partials,
               "max_abs_err": k3_err, "max_abs_want": k3_max, "nonzero_rows": k3_nonzero,
               "tol_relative": K3_TOL,
               "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound_ms,
               "index_add_ms": k3_lib_ms},
    }
    emit({"phase": "trainer_service", **summary})
    check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
          "K3 on the service's GAT input: shape or non-finite")
    check(k3_nonzero > 0, "the service's GAT run sent K3 only zero rows")
    check(k3_err <= K3_TOL * k3_max,
          f"K3 off its plain version by {k3_err} on the service's GAT input "
          f"(max |sum| {k3_max})")
    check(gat_launches["segment_sum"] == steps * layers,
          f"K3 launches {gat_launches['segment_sum']} != {steps} steps x {layers} layers "
          "in the service's GAT run")
    check(gat_metrics.mae < gat_mean_mae,
          f"service GAT validation MAE {gat_metrics.mae} not below the mean "
          f"predictor's {gat_mean_mae}")
    # The shards stay for phase 25, which deletes them.
    return summary


# ---------------------------------------------------------------------------
# The learned-scheduling loop: streaming trainer, lifecycle, rollout serving
# ---------------------------------------------------------------------------


def stream_phase(torch, dev, seed, out_dir):
    """Phase 7: the streaming MLP trainer at full width.  Returns its
    summary."""
    from dragonfly2_tpu_torch.models.mlp import MLPConfig, MLPRegressor
    from dragonfly2_tpu_torch.records.features import DOWNLOAD_FEATURE_DIM, mask_post_hoc
    from dragonfly2_tpu_torch.sim.lifecycle import LifecycleDrillConfig, _World
    from dragonfly2_tpu_torch.trainer.export import load_scorer, scorer_to_bytes
    from dragonfly2_tpu_torch.trainer.streaming import StreamingConfig, StreamingTrainer

    # run() never checkpoints: the step-128 checkpoint is taken below,
    # outside the timed window.
    cfg = StreamingConfig(seed=seed, checkpoint_every=10**9)
    mcfg = MLPConfig()
    bs = cfg.batch_size
    steps = STREAM_ROWS // bs
    t0 = time.perf_counter()
    rows = _World(LifecycleDrillConfig(seed=seed)).record_rows(
        STREAM_ROWS + (STREAM_PROFILE + 1) * bs + STREAM_HELD)
    batches = [rows[i * bs:(i + 1) * bs] for i in range(steps + STREAM_PROFILE + 1)]
    held = rows[-STREAM_HELD:]
    prep_s = time.perf_counter() - t0
    ckpt_dir = os.path.join(out_dir, "stream_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer = StreamingTrainer(cfg, mcfg, checkpoint_dir=ckpt_dir, device=dev)
    host_ms, losses = [], []
    lo, hi = STREAM_WINDOW
    pauses = (STREAM_CKPT, STREAM_CKPT + STREAM_RESUME_STEPS)
    window_s = 0.0
    t_train = time.perf_counter()
    for i in range(steps):
        trainer.feed(batches[i])
        t1 = time.perf_counter()
        trainer.run(max_steps=1, idle_timeout=0)
        host_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(trainer.last_loss)
        if lo <= i < hi and (trainer.step in pauses or i + 1 == hi):
            torch.cuda.synchronize()
            window_s += time.perf_counter() - t_seg
        if trainer.step == STREAM_CKPT:
            trainer.checkpoint()
        if trainer.step == STREAM_CKPT + STREAM_RESUME_STEPS:
            original_params = [p.detach().clone() for p in trainer.model.parameters()]
        if i + 1 == lo or (lo <= i < hi and trainer.step in pauses):
            torch.cuda.synchronize()
            t_seg = time.perf_counter()
    train_s = time.perf_counter() - t_train
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).float().cpu().numpy()
    launches = kernel_counts()
    window = host_ms[lo:hi]
    summary = {
        "prep_seconds": prep_s, "train_seconds": train_s, "steps": trainer.step,
        "batch": bs, "widths": [mcfg.in_dim, *mcfg.hidden, 1], "dtype": str(mcfg.dtype),
        "step_ms_p50": float(np.median(window)), "step_ms_p90": float(np.percentile(window, 90)),
        "window_steps": hi - lo, "window_mean_ms": window_s * 1e3 / (hi - lo),
        "records_per_s": bs * (hi - lo) / window_s,
        "peak_memory_gib": peak / 2**30, "kernel_launches": launches,
        "loss_first16": float(losses[:16].mean()), "loss_last16": float(losses[-16:].mean()),
        "losses_every16": losses[::16].tolist(),
    }
    check(trainer.step == steps and bool(np.isfinite(losses).all()), "stream: steps or losses")
    check(summary["loss_last16"] < summary["loss_first16"],
          f"stream loss did not fall: {summary['loss_first16']} -> {summary['loss_last16']}")
    check(not any(launches.values()), f"a kernel launched on the streaming path: {launches}")

    # The step-128 checkpoint, resumed in a fresh trainer, takes the same
    # batches as the original's steps 129..144.
    resumed = StreamingTrainer(cfg, mcfg, checkpoint_dir=ckpt_dir, device=dev)
    check(resumed.resume() and resumed.step == STREAM_CKPT, "stream: resume")
    for b in batches[STREAM_CKPT:STREAM_CKPT + STREAM_RESUME_STEPS]:
        resumed.feed(b)
    check(resumed.run(max_steps=STREAM_RESUME_STEPS, idle_timeout=0) == STREAM_RESUME_STEPS,
          "stream: resumed steps")
    mismatched = [n for (n, p), q in zip(resumed.model.named_parameters(), original_params)
                  if not torch.equal(p.detach(), q)]
    check(not mismatched, f"resumed parameters differ from the original's: {mismatched}")
    del resumed

    # 16 more steps under the profiler.
    extra = iter(batches[steps:])

    def one_step():
        trainer.feed(next(extra))
        trainer.run(max_steps=1, idle_timeout=0)

    profile = profile_steps(torch, one_step, steps=STREAM_PROFILE)

    # The exported scorer against the module on held rows: the module
    # computes in bf16, the numpy scorer in f32, so it is held at bf16
    # tolerance (3e-2 × max(1, |score|)); a float32 twin of the module
    # (same parameters) holds the export itself to 1e-4.
    scorer = trainer.export_scorer()
    feats = held[:, 2:2 + DOWNLOAD_FEATURE_DIM]
    x = torch.from_numpy((mask_post_hoc(feats) - trainer.moments.mean.astype(np.float32))
                         / trainer.moments.std.astype(np.float32)).to(dev)
    twin = MLPRegressor(dataclasses.replace(mcfg, dtype=torch.float32)).to(dev)
    twin.load_state_dict(trainer.model.state_dict())
    with torch.no_grad():
        want = trainer.model(x).float().cpu().numpy()
        want_f32 = twin(x).cpu().numpy()
    got = scorer.score(feats)
    export_err = np.abs(got - want)
    export_scaled = float(np.max(export_err / np.maximum(1.0, np.abs(want))))
    export_f32_err = float(np.max(np.abs(got - want_f32)))
    blob = scorer_to_bytes(scorer)
    round_trip = load_scorer(blob).score(feats)
    check(scorer.train_bin_edges is not None and scorer.train_bin_fracs is not None,
          "stream export carries no drift bins")
    check(bool(np.isfinite(got).all()) and export_scaled <= EXPORT_TOL,
          f"stream export off the bf16 module by {export_scaled} (scaled)")
    check(export_f32_err <= STREAM_EXPORT_F32_TOL,
          f"stream export off the float32 module by {export_f32_err}")
    check(np.array_equal(round_trip, got), "stream blob does not round-trip")
    summary.update({"resume_bit_identical": True,
                    "export_max_abs_err": float(export_err.max()),
                    "export_max_scaled_err": export_scaled, "export_tol_scaled": EXPORT_TOL,
                    "export_f32_max_abs_err": export_f32_err,
                    "export_f32_tol": STREAM_EXPORT_F32_TOL,
                    "held_max_abs_score": float(np.abs(want).max()), "blob_bytes": len(blob),
                    "drift_bins": list(scorer.train_bin_edges.shape)})
    emit({"phase": "stream", **summary})
    emit({"phase": "stream_profile", **profile})
    summary["profile"] = profile
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return summary


def lifecycle_phase(dev):
    """Phase 8: the zero-human lifecycle drill on the card."""
    from dragonfly2_tpu_torch.sim.lifecycle import LifecycleDrillConfig, run_lifecycle_drill

    reset_kernel_counts()
    t0 = time.perf_counter()
    out = run_lifecycle_drill(LifecycleDrillConfig(), device=dev)
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    summary = {
        "seconds": wall, "ok": out["ok"], "rolled_back": out["stage2"]["rolled_back"],
        "records_to_active_s": out["stage1"]["wall_s"],
        "regression_to_rollback_s": out["stage2"]["wall_s"],
        "bounce_resume_s": out["stage3"]["wall_s"],
        "pumps": [out[f"stage{i}"]["pumps"] for i in (1, 2, 3)],
        "rollback_reason": out["stage2"]["rollback_reason"], "events": out["events"],
        "kernel_launches": launches,
    }
    emit({"phase": "lifecycle", **summary})
    check(out["ok"], f"lifecycle drill not ok: {out}")
    check(out["stage2"]["rolled_back"], "lifecycle drill: the regression was not rolled back")
    check(not any(launches.values()), f"a kernel launched on the lifecycle path: {launches}")
    return summary


def register_round(service, hosts, urls, *, hosts_per_task, first, n):
    """``n`` sequential ``register_peer`` calls, requests ``first`` on,
    on ``serve_requests``' plan (a host of the next task's group, new to
    the task)."""
    n_tasks = len(urls)
    for q in range(first, first + n):
        task_i = q % n_tasks
        hi = ((task_i + 1) % n_tasks) * hosts_per_task + q // n_tasks
        service.register_peer(host=hosts[hi], url=urls[task_i], peer_id=f"roll-{q}")


def rollout_serving_phase(dev, seed, out_dir):
    """Phase 9: the lifecycle plane walks v1 to ACTIVE while a port
    scheduler, subscribed to its registry, serves announces.  The warm-up's
    finished downloads are written as Download records under ``out_dir``
    (one each, checked), then deleted."""
    from dragonfly2_tpu_torch.cli.scheduler import SchedulerConfig, build
    from dragonfly2_tpu_torch.manager.state import MemoryBackend
    from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
    from dragonfly2_tpu_torch.scheduler import ModelSubscriber
    from dragonfly2_tpu_torch.sim.lifecycle import LifecycleDrillConfig, _build_plane, _World
    from dragonfly2_tpu_torch.sim.swarm import host_from_latent
    from dragonfly2_tpu_torch.trainer.export import load_scorer

    # Sample floors above one pump's 480 joined edges: each phase spans
    # two daemon steps, so the subscriber's poll between them sees it.
    dcfg = LifecycleDrillConfig(seed=seed, min_shadow_samples=600, min_canary_samples=600)
    world = _World(dcfg)
    registry, _, daemon = _build_plane(dcfg, MemoryBackend(), world, {"invert": False}, dev)
    cfg = SchedulerConfig()
    cfg.storage.dir = os.path.join(out_dir, "rollout_records")
    shutil.rmtree(cfg.storage.dir, ignore_errors=True)
    cfg.scheduling.algorithm = "ml"
    cfg.scheduling.retry_interval_s = 0.0
    # Synthetic seed hosts: no daemon answers their port, so no trigger.
    service = build(cfg, device=dev, rng=random.Random(seed), seed_trigger=False)
    ev = service.scheduling.evaluator
    batcher = ev.batcher
    cluster = SyntheticCluster(num_hosts=ROLL_TASKS * ROLL_HOSTS_PER_TASK, seed=seed)
    hosts = [host_from_latent(lh) for lh in cluster.hosts]
    for h in hosts:
        service.announce_host(h)
    urls = warm_tasks(service, cluster, hosts, n_tasks=ROLL_TASKS,
                      hosts_per_task=ROLL_HOSTS_PER_TASK)
    warm_records = service.storage.download_count
    sub = ModelSubscriber(registry, ev, scheduler_id=dcfg.scheduler_id,
                          model_name=dcfg.model_name, rollout_client=daemon.client,
                          shadow_sample_rate=1.0)
    scored = []                               # (feature matrix, served scores)
    batch_score = batcher.score

    def recording(features, **kw):
        out = batch_score(features, **kw)
        scored.append((np.array(features, np.float32), np.array(out)))
        return out

    reset_kernel_counts()
    t0 = time.perf_counter()
    daemon.feed(world.record_rows(dcfg.epoch_records + dcfg.batch_size))
    rounds = []
    batcher.score = recording
    try:
        for r in range(ROLL_ROUNDS):
            daemon.step()
            sub.refresh()
            cand = registry.candidate_model(dcfg.scheduler_id, dcfg.model_name)
            active = registry.active_model(dcfg.scheduler_id, dcfg.model_name)
            rounds.append({
                "candidate": cand.state.value if cand else None,
                "active_version": active.version if active else 0,
                "shadow_attached": ev.shadow is not None,
                "canary_percent": ev.canary.percent if ev.canary else None,
                "serving_version": sub._loaded_version,
            })
            register_round(service, hosts, urls, hosts_per_task=ROLL_HOSTS_PER_TASK,
                           first=r * ROLL_PER_ROUND, n=ROLL_PER_ROUND)
            if active is not None and active.version == 1 and sub._loaded_version == 1:
                break
    finally:
        del batcher.score
        sub.stop()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    active = registry.active_model(dcfg.scheduler_id, dcfg.model_name)
    ref = load_scorer(registry.load_artifact(active)) if active else None
    exact = ref is not None and all(np.array_equal(ref.score(f), s) for f, s in scored)
    summary = {"seconds": wall, "rounds": rounds, "ml_scored_announces": len(scored),
               "served_rows": int(sum(len(s) for _, s in scored)),
               "scores_equal_registry_artifact": exact, "degrades": ev.degrades,
               "warm_download_records": warm_records, "kernel_launches": launches}
    emit({"phase": "rollout_serving", **summary})
    shutil.rmtree(cfg.storage.dir, ignore_errors=True)
    check(warm_records == ROLL_TASKS * ROLL_HOSTS_PER_TASK,
          f"{warm_records} Download records for "
          f"{ROLL_TASKS * ROLL_HOSTS_PER_TASK} finished warm-up downloads")
    phases = [x["candidate"] for x in rounds]
    check("shadow" in phases and "canary" in phases, f"rollout phases seen: {phases}")
    check(all(x["shadow_attached"] and x["canary_percent"] is None
              for x in rounds if x["candidate"] == "shadow"),
          "a SHADOW round without a shadow engine (or with a canary route)")
    check(all(x["shadow_attached"] and x["canary_percent"] == dcfg.canary_percent
              for x in rounds if x["candidate"] == "canary"),
          "a CANARY round without the canary route")
    check(active is not None and active.version == 1 and sub._loaded_version == 1
          and ev.shadow is None and ev.canary is None, "the subscriber does not serve v1")
    check(len(scored) > 0 and exact, "served ML scores differ from the registry artifact's")
    check(ev.degrades == 0, f"{ev.degrades} announces degraded to the rule ranking")
    check(not any(launches.values()), f"a kernel launched on the rollout path: {launches}")
    return summary


# ---------------------------------------------------------------------------
# The scheduler's record and probe half, then GraphSAGE on its probe graph
# ---------------------------------------------------------------------------


def simulate_cli(out_dir):
    """``cli.scheduler.run(["--simulate", N, "--device", "cuda"])`` with the
    record storage under ``out_dir``; → (rc, its last printed line, the
    line the reference prints for N)."""
    from dragonfly2_tpu_torch.cli import scheduler as scheduler_cli

    records = os.path.join(out_dir, "scheduler_simulate")
    shutil.rmtree(records, ignore_errors=True)
    old = os.environ.get("DRAGONFLY_SCHEDULER_STORAGE_DIR")
    os.environ["DRAGONFLY_SCHEDULER_STORAGE_DIR"] = records
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = scheduler_cli.run(["--simulate", str(SIM_CLI_DOWNLOADS), "--device", "cuda"])
    finally:
        if old is None:
            os.environ.pop("DRAGONFLY_SCHEDULER_STORAGE_DIR")
        else:
            os.environ["DRAGONFLY_SCHEDULER_STORAGE_DIR"] = old
    lines = buf.getvalue().strip().splitlines()
    # The reference's --simulate: 32 hosts, 8 tasks seeded by 2 downloads
    # each, one probe round in which every host probes 5 others (one
    # snapshot record per host).
    want = (f"scheduler: simulated {SIM_CLI_DOWNLOADS} downloads -> "
            f"{SIM_CLI_DOWNLOADS + 16} download records, 32 topology records (32 snapshots)")
    shutil.rmtree(records, ignore_errors=True)
    return rc, (lines[-1] if lines else ""), want


def dfc_rows(paths):
    from dragonfly2_tpu_torch.records.columnar import ColumnarReader

    return sum(len(ColumnarReader(p)) for p in paths)


def swarm_phase(torch, dev, seed, out_dir):
    """Phase 12: the scheduler's record and probe half — ``cli.scheduler
    --simulate``, then a 1,000-host swarm writing Download records and
    probes into record storage, the trainer binary on those shards, and
    parent choice by four evaluators.  Returns (summary, simulator)."""
    from dragonfly2_tpu_torch.cli import trainer as trainer_cli
    from dragonfly2_tpu_torch.manager.registry import ModelRegistry
    from dragonfly2_tpu_torch.records.storage import Storage
    from dragonfly2_tpu_torch.scheduler import Evaluator, MLEvaluator, ModelSubscriber
    from dragonfly2_tpu_torch.scheduler.evaluator import NetworkTopologyEvaluator
    from dragonfly2_tpu_torch.sim import SwarmConfig, SwarmSimulator
    from dragonfly2_tpu_torch.trainer.service import GNN_MODEL_NAME, MLP_MODEL_NAME

    reset_kernel_counts()
    rc, line, want_line = simulate_cli(out_dir)
    check(rc == 0, f"scheduler --simulate exited {rc}")
    check(line == want_line, f"scheduler --simulate printed {line!r}, not {want_line!r}")

    records = os.path.join(out_dir, "swarm_records")
    shutil.rmtree(records, ignore_errors=True)
    storage = Storage(records)
    writers, untap_writers = tap_record_writers()
    sim = SwarmSimulator(storage, config=SwarmConfig(num_hosts=SWARM_HOSTS, seed=seed),
                         rng=random.Random(seed))
    t0 = time.perf_counter()
    done = sim.run_downloads(SWARM_DOWNLOADS, tasks=SWARM_TASKS)
    dl_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    sim.run_probe_rounds(SWARM_PROBE_ROUNDS)
    probe_s = time.perf_counter() - t1
    snapshots = sim.snapshot_topology()
    storage.flush()
    untap_writers()
    dl_rows = dfc_rows(storage.download_columnar_paths())
    topo_rows = dfc_rows(storage.network_topology_columnar_paths())
    check_native_writes(writers, dl_rows + topo_rows, "swarm")
    ids, src, dst, rtt = sim.topology.to_edge_arrays()
    in_deg = np.bincount(dst, minlength=len(ids))

    registry = ModelRegistry()
    t2 = time.perf_counter()
    rc = trainer_cli.run(["--train-once", records, "--device", "cuda"], registry=registry)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t2
    models = {m.name: m for m in registry.list()}
    shutil.rmtree(records, ignore_errors=True)
    check(rc == 0, f"trainer --train-once on the swarm's shards exited {rc}")
    check(sorted(models) == sorted([MLP_MODEL_NAME, GNN_MODEL_NAME]),
          f"registered models: {sorted(models)}")

    # Parent choice on ground-truth bandwidth: the rule evaluator, the nt
    # evaluator over the swarm's probe store, and an ML evaluator fed each
    # registered model by a subscription.
    evaluators = {"rule": Evaluator(), "nt": NetworkTopologyEvaluator(sim.topology)}
    for label, name in (("mlp", MLP_MODEL_NAME), ("gnn", GNN_MODEL_NAME)):
        registry.activate(models[name].id)
        ev = MLEvaluator()
        ModelSubscriber(registry, ev, scheduler_id=models[name].scheduler_id,
                        model_name=name).refresh()
        check(ev.has_model, f"the {name} subscription installed no scorer")
        evaluators[label] = ev
    t3 = time.perf_counter()
    quality = {label: sim.measure_parent_choice_quality(ev, n_trials=SWARM_TRIALS, seed=1234)
               for label, ev in evaluators.items()}
    quality_s = time.perf_counter() - t3
    launches = kernel_counts()
    summary = {
        "simulate_cli_line": line, "hosts": SWARM_HOSTS, "downloads": done,
        "tasks": SWARM_TASKS, "download_seconds": dl_s, "downloads_per_s": done / dl_s,
        "probe_rounds": SWARM_PROBE_ROUNDS, "probe_seconds": probe_s,
        "probe_round_seconds": probe_s / SWARM_PROBE_ROUNDS,
        "download_records": storage.download_count, "download_rows": dl_rows,
        "topology_records": storage.network_topology_count, "topology_snapshots": snapshots,
        "topology_rows": topo_rows, "probe_graph": {
            "nodes": len(ids), "edges": int(len(src)), "mean_in_degree": float(in_deg.mean()),
            "max_in_degree": int(in_deg.max())},
        "round_seconds": round_s, "rc": rc,
        "models": {name: {"type": m.type, "version": m.version, "evaluation": m.evaluation}
                   for name, m in models.items()},
        "parent_choice_mb_s": quality, "parent_choice_trials": SWARM_TRIALS,
        "parent_choice_seconds": quality_s, "kernel_launches": launches,
    }
    emit({"phase": "swarm", **summary})
    check(done == SWARM_DOWNLOADS, f"{done} of {SWARM_DOWNLOADS} downloads simulated")
    check(dl_rows > 0 and topo_rows > 0, "the swarm wrote no DFC1 rows")
    check(quality["mlp"] > quality["rule"],
          f"MLP evaluator {quality['mlp']} MB/s not above the rules' {quality['rule']}")
    check(quality["gnn"] > quality["rule"],
          f"GNN evaluator {quality['gnn']} MB/s not above the rules' {quality['rule']}")
    check(not any(launches.values()), f"a kernel launched on the swarm path: {launches}")
    return summary, sim


def sage_workload(sim):
    """configs[1]'s graph: the swarm's probe graph (``to_edge_arrays``), the
    cluster's host features in the store's id order, K = 16, the target
    ``log1p(rtt / 1e6)``."""
    from dragonfly2_tpu_torch.models.gnn import build_neighbor_table

    ids, src, dst, rtt = sim.topology.to_edge_arrays()
    order = np.array([sim._host_index[h] for h in ids])
    n = len(ids)
    return {
        "n": n, "node_feats": sim.cluster._host_feature_matrix()[order],
        "table": build_neighbor_table(n, src, dst, rtt / 1e9, max_neighbors=SAGE_NEIGHBORS),
        "src": src, "dst": dst, "target": np.log1p(rtt / 1e6).astype(np.float32),
    }


def sage_phase(torch, dev, seed, sim):
    """Phase 13: GraphSAGE (configs[1]) on the swarm's probe graph with the
    K3 gather, its checks, the three gathers' steps and K3's times at this
    path's shapes.  Returns (summary, K3 launches, K3's error here)."""
    from dragonfly2_tpu_torch.models.gnn import GNNConfig
    from dragonfly2_tpu_torch.ops import segment
    from dragonfly2_tpu_torch.ops.segment import _segment_sum_plain, make_neighbor_gather
    from dragonfly2_tpu_torch.ops.transpose_gather import make_transpose_gather
    from dragonfly2_tpu_torch.trainer import train as train_mod
    from dragonfly2_tpu_torch.trainer.train import (
        TrainConfig, _graph_train_step, _SAGEEdgeModel, epoch_batches, split_edges,
    )

    t0 = time.perf_counter()
    work = sage_workload(sim)
    n = work["n"]
    gather = make_neighbor_gather(work["table"].indices, n, device=dev)
    prep_s = time.perf_counter() - t0
    mcfg = GNNConfig(gather_fn=gather)
    tcfg = TrainConfig(epochs=SAGE_EPOCHS, learning_rate=3e-3, warmup_steps=20, log_every=1,
                       seed=seed)
    seen = {}

    def keep_first_k3(fn):
        def wrapped(values, plan, **kw):
            seen.setdefault("k3", (values.detach().clone(), plan, kw))
            return fn(values, plan, **kw)
        return wrapped

    reset_kernel_counts()
    t1 = time.perf_counter()
    with tapped(segment, "segment_sum_bucketed", keep_first_k3):
        state, metrics, history = train_mod.train_graphsage(
            work["node_feats"], work["table"], work["src"], work["dst"], work["target"],
            model_config=mcfg, config=tcfg, device=dev, batch_size=SAGE_BATCH)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    launches = kernel_counts()
    k3_launches = launches["segment_sum"]
    steps = state.step
    losses = [h["loss"] for h in history]
    elapsed = [h["elapsed_s"] for h in history]
    step_ms = [(b - a) * 1e3 for a, b in zip(elapsed[1:], elapsed[2:])]   # steps 3..
    val_idx, train_idx = split_edges(len(work["target"]), seed)
    mean_mae = mean_predictor_mae(work["target"], val_idx, train_idx)

    # K3 against its plain version on the run's own first backward input;
    # these launches come after the counts were read.
    values, plan, k3_kw = seen["k3"]
    got = segment.segment_sum_bucketed(values, plan, **k3_kw)
    torch.cuda.synchronize()
    want = _segment_sum_plain(values, plan, exact=k3_kw["exact"],
                              presorted=k3_kw.get("presorted", False))
    k3_err = float((got - want).abs().max())
    k3_max = float(want.abs().max())

    # One step from the trained state with each gather (the same generator
    # state), then each gather's step time on the first batch.
    idx = next(epoch_batches(train_idx, SAGE_BATCH, seed, 0))
    args = (torch.from_numpy(work["node_feats"]).to(dev), work["table"].to(dev),
            torch.from_numpy(work["src"][idx]).to(dev), torch.from_numpy(work["dst"][idx]).to(dev),
            torch.from_numpy(work["target"][idx]).to(dev), None)
    gathers = {"k3": gather, "index": None,
               "transpose": make_transpose_gather(work["table"].indices, work["table"].mask, n,
                                                  device=dev)}
    models = {}
    for name, g in gathers.items():
        m = _SAGEEdgeModel(dataclasses.replace(mcfg, gather_fn=g), num_nodes=n,
                           in_dim=work["node_feats"].shape[1]).to(dev)
        m.load_state_dict(state.model.state_dict())
        models[name] = m
    equiv = gather_equivalence(torch, state, models, args, dev)
    step_times = gather_step_times(torch, state, models, args, tcfg)
    fastest = min(step_times, key=lambda k: step_times[k]["p50_ms"])
    # K3 alone at this path's two shapes, against its plain version, with
    # its device time, bound and index_add_'s time.
    rng = np.random.default_rng(seed)
    rows = n * SAGE_NEIGHBORS
    flat_ids = gather.flat_indices
    shapes = {}
    for d in (44, 128):
        vals = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32)).to(
            torch.bfloat16).to(dev)
        sgot = segment.segment_sum_bucketed(vals, plan, exact=False)
        torch.cuda.synchronize()
        swant = _segment_sum_plain(vals, plan, exact=False, presorted=False)
        err = float((sgot - swant).abs().max())
        scale = max(1.0, float(swant.abs().max()))
        check(err <= K3_TOL * scale, f"K3 off its plain version by {err} at [{rows}, {d}]")
        vals32 = vals.float()
        bound_ms, bound_by = bound(*k3_cost(plan, d, 2))
        shapes[d] = {
            "rows": rows, "max_abs_err": err, "max_abs_want": scale,
            "ms": device_ms(lambda: segment.segment_sum_bucketed(vals, plan, exact=False)),
            "plain_ms": device_ms(lambda: _segment_sum_plain(vals, plan, exact=False,
                                                             presorted=False), samples=5, reps=2),
            "index_add_ms": device_ms(lambda: torch.zeros((n, d), device=dev).index_add_(
                0, flat_ids, vals32), samples=10, reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by}
        shapes[d]["share_of_bound"] = bound_ms / shapes[d]["ms"]
    prof = profile_steps(torch, lambda: _graph_train_step(state, *args), steps=SAGE_PROFILE)
    summary = {
        "nodes": n, "probe_edges": int(len(work["src"])), "neighbors": SAGE_NEIGHBORS,
        "prep_seconds": prep_s, "train_seconds": train_s, "steps": steps,
        "k3_launches": k3_launches, "kernel_launches": launches, "losses_first_last": [
            losses[:8], losses[-8:]], "metrics": metrics.to_dict(),
        "mean_predictor_mae": mean_mae, "step_ms_p50_k3_run": float(np.median(step_ms)),
        "k3_path": {"rows": int(values.shape[0]), "d": int(values.shape[1]),
                    "dtype": str(values.dtype), "segments": plan.num_segments,
                    "max_abs_err": k3_err, "max_abs_want": k3_max, "tol_relative": K3_TOL},
        "step_equivalence": equiv, "gather_step_ms": step_times, "fastest_gather": fastest,
        "k3": shapes, "profile": prof,
    }
    emit({"phase": "sage", **summary})
    check(steps == SAGE_EPOCHS * (len(train_idx) // SAGE_BATCH), f"{steps} SAGE steps")
    check(k3_launches == 2 * steps, f"K3 launches {k3_launches} != 2 x {steps} SAGE steps")
    check(launches["fused_gather_mlp_score"] == 0 and launches["rule_weighted_sum"] == 0,
          f"K1/K2 launched by the SAGE run: {launches}")
    check(len(losses) == steps and all(np.isfinite(losses)), "a non-finite or missing loss")
    check(float(np.mean(losses[-8:])) < float(np.mean(losses[:8])),
          f"SAGE loss did not fall: {losses[:8]} -> {losses[-8:]}")
    check(metrics.mae < mean_mae, f"SAGE val MAE {metrics.mae} not below the mean "
          f"predictor's {mean_mae}")
    check(bool(torch.isfinite(got).all()) and k3_max > 0, "K3 on the SAGE input: zero or non-finite")
    check(k3_err <= K3_TOL * k3_max,
          f"K3 off its plain version by {k3_err} on the SAGE run's input (max |sum| {k3_max})")
    for name in ("index", "transpose"):
        check(equiv[name]["loss_rel"] <= STEP_LOSS_TOL,
              f"SAGE step loss with the {name} gather off the K3 step: {equiv}")
        check(equiv[name]["grad_abs_sum_rel"] <= STEP_GRAD_TOL,
              f"SAGE step gradients with the {name} gather off the K3 step: {equiv}")
        check(equiv[name]["grad_l2_rel"] <= STEP_GRAD_L2_TOL,
              f"SAGE step gradients with the {name} gather off the K3 step (L2): {equiv}")
    return summary, k3_launches, max([k3_err] + [v["max_abs_err"] for v in shapes.values()])


def gather_equivalence(torch, state, models, args, dev):
    """Loss and gradients of one step on ``args`` with each of ``models``
    (the same parameters, another gather each), dropout from ``state``'s
    generator state in every one; each against the ``"k3"`` model's."""
    from dragonfly2_tpu_torch.trainer.train import TrainState, _graph_loss_and_grads

    gen_state = state.generator.get_state()
    out = {}
    for name, model in models.items():
        gen = torch.Generator(device=dev)
        gen.set_state(gen_state)
        loss, grads = _graph_loss_and_grads(
            TrainState(model=model, opt=None, generator=gen), *args)
        out[name] = (float(loss), [g.double() for g in grads])
    l0, g0 = out["k3"]
    abs0 = sum(float(g.abs().sum()) for g in g0)
    norm = sum(float((a ** 2).sum()) for a in g0) ** 0.5
    res = {}
    for name in sorted(models.keys() - {"k3"}):
        l1, g1 = out[name]
        abs1 = sum(float(g.abs().sum()) for g in g1)
        diff = sum(float(((a - b) ** 2).sum()) for a, b in zip(g0, g1)) ** 0.5
        res[name] = {"loss_k3": l0, "loss": l1, "loss_rel": abs(l0 - l1) / max(abs(l0), 1e-6),
                     "grad_abs_sum_rel": abs(abs0 - abs1) / max(abs0, 1e-6),
                     "grad_l2_rel": diff / norm}
    return res


def gather_step_times(torch, state, models, args, tcfg):
    """Host ms of one train step (ended by its loss reaching the host) with
    each gather, in turns: SAGE_TIMED_STEPS steps each, a fresh optimizer
    per model so the trained state is left as it is."""
    from dragonfly2_tpu_torch.trainer.train import TrainState, _graph_train_step, _make_optimizer

    states = {name: TrainState(model=m, opt=_make_optimizer(list(m.parameters()), tcfg, 8),
                               generator=torch.Generator(device=args[0].device).manual_seed(1))
              for name, m in models.items()}
    times = {name: [] for name in models}
    for name, st in states.items():          # warm-up
        float(_graph_train_step(st, *args)[1])
    for _ in range(SAGE_TIMED_STEPS):
        for name, st in states.items():
            t0 = time.perf_counter()
            float(_graph_train_step(st, *args)[1])
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: {"p50_ms": float(np.median(t)), "min_ms": float(np.min(t)),
                   "steps": len(t)} for name, t in times.items()}


# ---------------------------------------------------------------------------
# The online graph trainer (configs[4]) and federated FedAvg (configs[3])
# ---------------------------------------------------------------------------


def _train_state_copy(trainer):
    """Everything a dispatch reads and writes of an online trainer's state."""
    st = trainer.state
    return ([p.detach().clone() for p in st.opt.params], [m.clone() for m in st.opt.mu],
            [v.clone() for v in st.opt.nu], st.opt.count, st.step, st.generator.get_state())


def _train_state_restore(torch, trainer, saved):
    st = trainer.state
    params, mu, nu, count, step, gen = saved
    with torch.no_grad():
        for dst, src in zip(st.opt.params + st.opt.mu + st.opt.nu, params + mu + nu):
            dst.copy_(src)
    st.opt.count, st.step = count, step
    st.generator.set_state(gen)


def same_state_dispatches(torch, trainer, staged, atomic):
    """``OG_DET_RUNS`` dispatches of one block, each from the same saved
    state: the state hash after each and its device ms.  With ``atomic``
    the embedding's gather is ``index_select`` (whose backward adds a
    repeated id's rows with atomics) in place of ``Embed``'s sorted
    backward.  The state and the gather are restored after."""
    from dragonfly2_tpu_torch.trainer.online_graph import state_hash

    embed = trainer.state.model.HopEncoder_0.Embed_0
    saved = _train_state_copy(trainer)
    hashes, ms = [], []
    if atomic:
        embed.forward = lambda ids: embed.embedding.index_select(0, ids)
    try:
        for _ in range(OG_DET_RUNS):
            _train_state_restore(torch, trainer, saved)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            trainer._train_dispatch(*staged)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            hashes.append(state_hash(trainer.state))
    finally:
        embed.__dict__.pop("forward", None)
        _train_state_restore(torch, trainer, saved)
    return {"identical": len(set(hashes)) == 1, "hashes": [h[:16] for h in hashes], "ms": ms}


def online_graph_phase(torch, dev, seed, out_dir):
    """Phase 14: the online graph trainer (configs[4]) at full width — run
    A through the trainer service's online sink, runs B and C for a
    resume across a refresh, a same-state determinism probe, a profile.
    Returns its summary."""
    from dragonfly2_tpu_torch.bench import online_graph as bench

    rows_per_dispatch = OG_BATCH * OG_SUPER
    root = os.path.join(out_dir, "online_graph")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    common = ["--seed", str(seed), "--nodes", str(OG_NODES), "--hidden", str(OG_HIDDEN),
              "--batch", str(OG_BATCH), "--super", str(OG_SUPER),
              "--refresh-every", str(OG_REFRESH), "--warmup-steps", str(OG_WARMUP),
              "--device", "cuda"]

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    # -- run A: through the wire ------------------------------------------
    keep = []
    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    a = bench.run(bench.parse_args(common + [
        "--wire", "--records", str(OG_DISPATCHES * rows_per_dispatch),
        "--ckpt-dir", os.path.join(root, "a")]), log=log, keep=keep)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = kernel_counts()
    trainer = keep.pop()
    losses = np.asarray(a["losses"])
    refreshes = a["refreshes"]
    summary = {
        "nodes": OG_NODES, "hidden": OG_HIDDEN, "batch": OG_BATCH, "super_steps": OG_SUPER,
        "wire": {k: v for k, v in a.items()
                 if k not in ("losses", "dispatch_ms", "dispatch_host_ms")},
        "losses": losses.tolist(), "dispatch_ms": a["dispatch_ms"],
        "dispatch_host_ms": a["dispatch_host_ms"],
        "dispatch_ms_p50": float(np.median(a["dispatch_ms"])),
        "refresh_mae": [{k: r[k] for k in ("dispatch", "stale_mae", "fresh_mae", "hop_rms",
                                           "hop_column_rms_moved_max")}
                        for r in refreshes],
        "device_records_per_s": rows_per_dispatch / (float(np.median(a["dispatch_ms"])) / 1e3),
        "records_per_s_service": a["records_per_s_service"],
        "peak_memory_gib": peak / 2**30, "kernel_launches": launches,
    }
    emit({"phase": "online_graph_wire", **summary})
    sent = OG_DISPATCHES * rows_per_dispatch
    check(a["ingest"]["native"] and a["ingest"]["stats"]["rows_in"] == sent,
          f"online graph run A: the native ingest engine did not run on every row: "
          f"{a['ingest']}")
    check(bool(np.isfinite(losses).all()) and len(losses) == OG_DISPATCHES,
          f"online graph: {len(losses)} dispatch losses, finite: {np.isfinite(losses).all()}")
    check(losses[-4:].mean() < losses[:4].mean(),
          f"online graph loss did not fall: {losses[:4].mean()} -> {losses[-4:].mean()}")
    check(a["records_seen"] == a["rows_sent"] == a["rows_off_the_wire"] == sent
          and a["leftover_rows"] == 0 and a["overflow_edges"] == 0,
          f"online graph rows: sent {a['rows_sent']}, off the wire {a['rows_off_the_wire']}, "
          f"trained {a['records_seen']}, left {a['leftover_rows']}, "
          f"dropped {a['overflow_edges']} (want {sent})")
    check(len(refreshes) == OG_DISPATCHES // OG_REFRESH - 1
          and a["snapshots"] == len(refreshes) + 1,
          f"online graph: {len(refreshes)} refreshes, snapshot_idx {a['snapshots']}")
    # On the post-drift edges the fresh snapshot is held to beat the stale
    # one at the last refresh (96 steps in).  Earlier refreshes are
    # printed, not held: the JAX package's trainer, in this world at
    # hidden 1,024 on the CPU, scores 1.1 % worse right after the first
    # swap, and the port moves as it does at every refresh
    # (tests/test_torch_online_drift.py).
    last = refreshes[-1]
    check(last["fresh_mae"] <= last["stale_mae"],
          f"online graph: the last refresh's fresh snapshot scored worse than the stale "
          f"one: {last}")
    check(not any(launches.values()), f"a kernel launched on the online graph path: {launches}")

    # -- run A again on the same records, the adapter's Python path -------
    reset_kernel_counts()
    py_sent = OG_PY_DISPATCHES * rows_per_dispatch
    py = bench.run(bench.parse_args(common + [
        "--wire", "--python-ingest", "--records", str(py_sent),
        "--ckpt-dir", os.path.join(root, "a_python")]), log=log)
    torch.cuda.synchronize()
    py_launches = kernel_counts()
    py_device = rows_per_dispatch / (float(np.median(py["dispatch_ms"])) / 1e3)
    summary["ingest_arms"] = {
        "native": {"records_per_s_service": a["records_per_s_service"],
                   "device_records_per_s": summary["device_records_per_s"],
                   "service_s": a["service_s"], "stats": a["ingest"]["stats"]},
        "python": {"records_per_s_service": py["records_per_s_service"],
                   "device_records_per_s": py_device, "service_s": py["service_s"],
                   "losses": py["losses"]},
    }
    emit({"phase": "online_graph_ingest_arms", **summary["ingest_arms"]})
    check(not py["ingest"]["native"] and py["records_seen"] == py["rows_sent"]
          == py["rows_off_the_wire"] == py_sent and py["overflow_edges"] == 0,
          f"online graph Python-ingest arm: native {py['ingest']['native']}, sent "
          f"{py['rows_sent']}, off the wire {py['rows_off_the_wire']}, trained "
          f"{py['records_seen']} (want {py_sent})")
    check(bool(np.isfinite(py["losses"]).all()), "online graph Python-ingest arm: a "
          "non-finite loss")
    check(not any(py_launches.values()),
          f"a kernel launched on the online graph path: {py_launches}")

    # -- the same block twice from one state; a profile of two dispatches -
    world = bench._World(OG_NODES, OG_BATCH, OG_SUPER, seed)
    block = world.download_block(0)
    staged = trainer._stage(tuple(b.reshape(OG_SUPER, OG_BATCH) for b in block))
    determinism = {"sorted": same_state_dispatches(torch, trainer, staged, False),
                   "index_select": same_state_dispatches(torch, trainer, staged, True)}
    profile = profile_steps(torch, lambda: trainer._train_dispatch(*staged), steps=OG_PROFILE)
    del trainer, staged, keep
    emit({"phase": "online_graph_determinism", **determinism})
    emit({"phase": "online_graph_profile", **profile})
    check(determinism["sorted"]["identical"],
          f"one dispatch from one state differs from itself: {determinism['sorted']}")

    # -- runs B and C: a resume across the refresh at dispatch 4 ----------
    resume = common + ["--records", str(OG_RESUME_TOTAL * rows_per_dispatch),
                       "--ckpt-every", "1000000", "--eval-every", str(OG_REFRESH)]
    reset_kernel_counts()
    b = bench.run(bench.parse_args(resume + ["--ckpt-dir", os.path.join(root, "b")]), log=log)
    c = bench.run(bench.parse_args(resume + ["--ckpt-dir", os.path.join(root, "c"),
                                             "--kill-after-dispatch", str(OG_KILL_AT)]), log=log)
    r = bench.run(bench.parse_args(resume + ["--ckpt-dir", os.path.join(root, "c"),
                                             "--resume"]), log=log)
    resume_launches = kernel_counts()
    summary.update({
        "determinism": determinism, "profile": profile,
        "resume": {"b": {k: b[k] for k in ("dispatches", "snapshots", "state_hash", "losses",
                                           "refreshes", "dispatch_ms", "train_s")},
                   "c_killed_at": c["killed_at"], "c_snapshots": c["snapshots"],
                   "resumed_at": r["resumed_at"], "resumed_dispatches": r["dispatches"],
                   "resumed_hash": r["state_hash"]},
    })
    emit({"phase": "online_graph_resume", **summary["resume"]})
    check(b["dispatches"] == OG_RESUME_TOTAL and b["snapshots"] == 1,
          f"run B: {b['dispatches']} dispatches, snapshot {b['snapshots']}")
    check(c["killed_at"] == OG_KILL_AT and r["resumed_at"]["dispatch"] == OG_KILL_AT
          and r["resumed_at"]["snapshot"] == 1 and r["dispatch"] == OG_RESUME_TOTAL,
          f"run C: killed at {c['killed_at']}, resumed at {r['resumed_at']}, "
          f"ended at {r['dispatch']}")
    check(r["state_hash"] == b["state_hash"],
          f"resumed state {r['state_hash'][:16]} != straight run {b['state_hash'][:16]}")
    check(all(np.isfinite(b["losses"])), "run B: a non-finite loss")
    check(not any(resume_launches.values()),
          f"a kernel launched on the online graph path: {resume_launches}")
    shutil.rmtree(root, ignore_errors=True)
    return summary


def federated_phase(torch, dev, seed):
    """Phase 15: federated FedAvg (configs[3]) over 8 scheduler-cluster
    shards on the card.  Returns its summary."""
    from dragonfly2_tpu_torch.manager.registry import ModelRegistry
    from dragonfly2_tpu_torch.models.mlp import MLPConfig, MLPRegressor
    from dragonfly2_tpu_torch.records.features import DOWNLOAD_FEATURE_DIM, mask_post_hoc
    from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
    from dragonfly2_tpu_torch.trainer import federated
    from dragonfly2_tpu_torch.trainer.export import load_scorer

    t0 = time.perf_counter()
    shards, held = [], []
    for c in range(FED_SHARDS):
        rows = SyntheticCluster(num_hosts=FED_HOSTS, seed=1000 * seed + 100 + c) \
            .generate_feature_rows(FED_ROWS + FED_HELD, seed=c)
        shards.append(federated.ClusterShard(f"cluster-{c}", rows[:FED_ROWS]))
        held.append(rows[FED_ROWS:])
    held = np.concatenate(held)
    prep_s = time.perf_counter() - t0
    cfg = federated.FederatedConfig(seed=seed)
    trainer = federated.FederatedTrainer(shards, config=cfg, device=dev)
    round_s, last = [], {}

    def timed_round(fn):
        def wrapped():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t1)
        return wrapped

    def keep_mean(fn):
        def wrapped(trees, weights):
            out = fn(trees, weights)
            last.update(trees=trees, weights=list(weights), out=out)
            return out
        return wrapped

    reset_kernel_counts()
    with tapped(federated, "_tree_weighted_mean", keep_mean), \
            tapped(trainer, "run_round", timed_round):
        metrics = trainer.run(held)
    launches = kernel_counts()
    maes = [h["mae"] for h in trainer.history]
    pooled = np.concatenate([s.rows[:, -1] for s in shards])
    mean_mae = float(np.mean(np.abs(held[:, -1] - pooled.mean())))
    b = min(cfg.batch_size, FED_ROWS)
    rows_per_round = FED_SHARDS * cfg.local_epochs * (FED_ROWS // b) * b

    # The round's aggregate against the reference's numpy weighted mean of
    # the 8 local models (float32, x * (w / total) summed in shard order).
    total = float(sum(last["weights"]))
    mean_err = 0.0
    for k, got in last["out"].items():
        want = None
        for t, wi in zip(last["trees"], last["weights"]):
            part = t[k].cpu().numpy() * (wi / total)
            want = part if want is None else np.add(want, part)
        mean_err = max(mean_err, float(np.max(np.abs(got.cpu().numpy() - want))))

    # publish → registry → load_scorer, against a float32 twin of the
    # global model (the scorer's own arithmetic) and the bf16 model.
    registry = ModelRegistry()
    model = trainer.publish(registry)
    scorer = load_scorer(registry.load_artifact(model))
    feats = held[:, 2:2 + DOWNLOAD_FEATURE_DIM]
    scores = scorer.score(feats)
    pred_bf16 = trainer.predict(held)
    twin = MLPRegressor(dataclasses.replace(MLPConfig(), dtype=torch.float32)).to(dev)
    twin.load_state_dict(trainer.model.state_dict())
    x = torch.from_numpy(((mask_post_hoc(feats) - trainer.feat_mean) / trainer.feat_std)
                         .astype(np.float32)).to(dev)
    with torch.no_grad():
        pred_f32 = twin(x).cpu().numpy()
    f32_scaled = float(np.max(np.abs(scores - pred_f32) / np.maximum(1.0, np.abs(pred_f32))))
    bf16_scaled = float(np.max(np.abs(scores - pred_bf16) / np.maximum(1.0, np.abs(pred_bf16))))
    summary = {
        "shards": FED_SHARDS, "hosts_per_cluster": FED_HOSTS, "rows_per_shard": FED_ROWS,
        "held_rows": int(len(held)), "rounds": cfg.rounds, "local_epochs": cfg.local_epochs,
        "batch": cfg.batch_size, "prep_seconds": prep_s, "round_seconds": round_s,
        "records_per_s": rows_per_round / float(np.median(round_s)),
        "mae_per_round": maes, "final": metrics.to_dict(), "mean_predictor_mae": mean_mae,
        "aggregate_max_abs_err": mean_err, "aggregate_tol": FED_MEAN_TOL,
        "export_f32_max_scaled_err": f32_scaled, "export_f32_tol_scaled": FED_F32_TOL,
        "export_bf16_max_scaled_err": bf16_scaled, "export_tol_scaled": EXPORT_TOL,
        "registered_version": model.version, "kernel_launches": launches,
    }
    emit({"phase": "federated", **summary})
    check(len(maes) == cfg.rounds and all(np.isfinite(maes)), f"federated MAEs {maes}")
    check(maes[-1] < maes[0] and maes[-1] < mean_mae,
          f"federated MAE {maes} did not fall below the mean predictor's {mean_mae}")
    check(mean_err <= FED_MEAN_TOL, f"federated aggregate off numpy's mean by {mean_err}")
    check(f32_scaled <= FED_F32_TOL, f"published scorer off the float32 model by {f32_scaled}")
    check(bf16_scaled <= EXPORT_TOL, f"published scorer off the bf16 model by {bf16_scaled}")
    check(not any(launches.values()), f"a kernel launched on the federated path: {launches}")
    return summary


@contextlib.contextmanager
def keep_k1_flushes(seen, cap=None):
    """Taps ``FusedMLPScorer.score`` inside the block: ``seen`` keeps the
    inputs of the first ``cap`` (``WIRE_K1_FLUSHES``) flushes, with the scorer
    that made each (``scorers``; a path with several schedulers has one a
    shard, each gathering from its own slot mirror), the slot mirror the
    flush itself gathered from (``mirrors``: the tensor its own
    ``_sync_mirror`` returned, on its thread; a re-sync replaces the
    tensor, so the kept one holds the flush's rows while later announces
    rebind slots), whether each gathered slot was bound in the store as
    the flush began (``bound``) and the last scorer."""
    from dragonfly2_tpu_torch.ops.fused_score import FusedMLPScorer

    local = threading.local()
    sync, score = FusedMLPScorer._sync_mirror, FusedMLPScorer.score

    def synced(self):
        local.mat = sync(self)
        return local.mat

    limit = WIRE_K1_FLUSHES if cap is None else cap

    def scored(self, features, *, src_buckets=None, dst_buckets=None):
        keep = len(seen["flushes"]) < limit
        if keep:
            store = self._store
            with store._mu:
                held = np.fromiter((e[0] for e in store._entries.values()), np.int64)
            bound = (np.isin(src_buckets, held), np.isin(dst_buckets, held))
        local.mat = None
        out = score(self, features, src_buckets=src_buckets, dst_buckets=dst_buckets)
        if keep and len(seen["flushes"]) < limit:
            seen.setdefault("live_finite", []).append(bool(np.isfinite(out).all()))
            seen["scorer"] = self
            seen.setdefault("scorers", []).append(self)
            seen.setdefault("mirrors", []).append(local.mat)
            seen.setdefault("bound", []).append(bound)
            seen["flushes"].append((np.array(features, np.float32, copy=True),
                                    np.array(src_buckets, copy=True),
                                    np.array(dst_buckets, copy=True)))
        return out

    FusedMLPScorer._sync_mirror, FusedMLPScorer.score = synced, scored
    try:
        yield
    finally:
        FusedMLPScorer._sync_mirror, FusedMLPScorer.score = sync, score


def k1_save_dir(out_dir):
    """Where a phase's K1 flushes past the limit are saved."""
    return os.path.join(out_dir, "k1_flushes")


def k1_on_flushes(torch, dev, seen, save_dir=None, phase=""):
    """K1 against its plain version on a path's own flushes, each on the
    slot mirror it gathered from (its scorer's, as it stood at the flush:
    the rows its slots held then; these launches come after the counts),
    and K1's, the plain version's and the bound's ms at 128 rows (the pad
    most flushes take) of the first flush's mirror and rows → (max err
    scaled, ms, plain ms, bound ms).  A flush past ``K1_TOL`` is saved
    under ``save_dir`` (``bench/k1_replay.save_flush``: its mirror, slots,
    edges, the scorer's weights and which slots were bound) and replayed
    there by ``python -m dragonfly2_tpu_torch.bench.k1_replay FILE``."""
    from dragonfly2_tpu_torch.bench import k1_replay
    from dragonfly2_tpu_torch.ops import fused_score

    k1_err = 0.0
    k1_in = []
    first = seen["mirrors"][0]
    for i, (scorer, mat, (edge, src, dst)) in enumerate(zip(
            seen["scorers"], seen["mirrors"], seen["flushes"])):
        mlp = scorer.mlp
        s = torch.from_numpy(src.astype(np.int32)).to(dev)
        d = torch.from_numpy(dst.astype(np.int32)).to(dev)
        e = torch.from_numpy(edge).to(dev)
        got = fused_score.fused_gather_mlp_score(mat, s, d, e, mlp)
        want = fused_score._fused_score_plain(mat, s, d, e, mlp.w0c, mlp.w0p, mlp.w0e,
                                              mlp.b0, mlp.layers())
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(got).all())
        err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
        if not finite or not err <= K1_TOL:
            # What the flush held, saved for the replay and printed before
            # the caller's check fails.
            bound_src, bound_dst = seen["bound"][i]
            bad = ~torch.isfinite(got) | ~((got - want).abs() <= K1_TOL)
            rows = torch.cat([s[bad], d[bad]]).long()
            saved = None
            if save_dir is not None:
                os.makedirs(save_dir, exist_ok=True)
                saved = k1_replay.save_flush(
                    os.path.join(save_dir, f"k1_flush_{phase or 'path'}_{i}.pt"),
                    mat=mat, slots=s, dslots=d, edge=e, weights=scorer._ref.weights,
                    post_hoc_masked=scorer._ref.post_hoc_masked, mlp=mlp,
                    bound_src=bound_src, bound_dst=bound_dst, err=err, phase=phase, flush=i)
            emit({"phase": "k1_flush_off_plain", "path": phase, "flush": i,
                  "err_scaled": err, "rows": int(s.numel()), "k1_finite": finite,
                  "plain_finite": bool(torch.isfinite(want).all()),
                  "live_scores_finite": seen["live_finite"][i],
                  "rows_off": int(bad.sum()),
                  "slots_off": [int(x) for x in s[bad][:8]] + [int(x) for x in d[bad][:8]],
                  "bound_off": [bool(x) for x in bound_src[bad.cpu().numpy()][:8]]
                  + [bool(x) for x in bound_dst[bad.cpu().numpy()][:8]],
                  "rows_off_nonfinite_values": int((~torch.isfinite(mat[rows])).sum()),
                  "rows_off_max_abs": float(mat[rows].abs().max()) if rows.numel() else None,
                  "mirror_nonfinite_values": int((~torch.isfinite(mat)).sum()),
                  "slot_rows_max_abs": float(mat[torch.cat([s, d]).long()].abs().max()),
                  "unbound_slots": int((~bound_src).sum() + (~bound_dst).sum()),
                  "edge_max_abs": float(e.abs().max()),
                  "want_max_abs": float(want.abs().max()), "saved": saved})
        check(finite and bool(torch.isfinite(want).all()),
              f"K1 or its plain version non-finite on a flush of {phase or 'the path'}")
        k1_err = max(k1_err, err)
        if mat is first:
            k1_in.append((s, d, e))
    mat, mlp = first, seen["scorers"][0].mlp
    s128, d128, e128 = (torch.cat([x[i] for x in k1_in])[:128] for i in range(3))
    d1, d2 = mlp.w0c.shape[1], mlp.w1.shape[1]
    k1_ms = device_ms(lambda: fused_score.fused_gather_mlp_score(mat, s128, d128, e128, mlp))
    k1_plain_ms = device_ms(lambda: fused_score._fused_score_plain(
        mat, s128, d128, e128, mlp.w0c, mlp.w0p, mlp.w0e, mlp.b0, mlp.layers()))
    k1_bound_ms, _ = bound(*k1_cost(int(s128.numel()), d1, d2, mlp.k1_blob.numel()))
    return k1_err, k1_ms, k1_plain_ms, k1_bound_ms


def wire_loop_phase(torch, dev, seed, out_dir):
    """Phase 16: the deployment over real sockets (``bench/wire_loop``),
    then each binary's boot in serve mode.  Returns (summary, K1's
    launches and flush inputs, K3's launches and tapped input)."""
    from dragonfly2_tpu_torch.bench import wire_loop
    from dragonfly2_tpu_torch.ops import segment
    from dragonfly2_tpu_torch.ops.segment import _segment_sum_plain
    from dragonfly2_tpu_torch.trainer import train as train_mod

    seen = {"flushes": [], "gat_steps": []}

    def keep_first_k3(fn):
        def wrapped(values, plan, **kw):
            seen.setdefault("k3", (values.detach().clone(), plan, kw))
            return fn(values, plan, **kw)
        return wrapped

    def keep_steps(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            seen["gat_steps"].append(out[0].step * kw["model_config"].num_layers)
            return out
        return wrapped

    def keep_gather(fn):
        def wrapped(*a, **kw):
            gather = fn(*a, **kw)
            seen.setdefault("gather", gather)
            return gather
        return wrapped

    work = os.path.join(out_dir, "wire_loop")
    shutil.rmtree(work, ignore_errors=True)
    args = wire_loop.parse_args([
        "--hosts", str(SWARM_HOSTS), "--downloads", str(WIRE_DOWNLOADS),
        "--tasks", str(SWARM_TASKS), "--probe-rounds", str(WIRE_PROBE_ROUNDS),
        "--clients", str(WIRE_CLIENTS), "--sequential", str(WIRE_SEQUENTIAL),
        "--trials", str(WIRE_TRIALS), "--train-interval", str(WIRE_TRAIN_INTERVAL),
        "--seed", str(seed), "--out", work, "--device", "cuda",
    ])
    reset_kernel_counts()
    sheds0 = shed_counts()
    t0 = time.perf_counter()
    with keep_k1_flushes(seen), \
            tapped(segment, "segment_sum_bucketed", keep_first_k3), \
            tapped(segment, "make_neighbor_gather", keep_gather), \
            tapped(train_mod, "train_gat_ranker", keep_steps):
        summary = wire_loop.run(args, log=lambda line: print(line, flush=True))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernel_counts()
    shutil.rmtree(work, ignore_errors=True)

    k1_err, k1_ms, k1_plain_ms, k1_bound_ms = k1_on_flushes(
        torch, dev, seen, k1_save_dir(out_dir), "wire_loop")

    # K3 against its plain version on the GAT run's own first input.
    values, plan, k3_kw = seen["k3"]
    got = segment.segment_sum_bucketed(values, plan, **k3_kw)
    torch.cuda.synchronize()
    want = _segment_sum_plain(values, plan, exact=k3_kw["exact"],
                              presorted=k3_kw.get("presorted", False))
    k3_err = float((got - want).abs().max())
    k3_max = float(want.abs().max())
    k3_ms = device_ms(lambda: segment.segment_sum_bucketed(values, plan, **k3_kw))
    k3_plain_ms = device_ms(lambda: _segment_sum_plain(
        values, plan, exact=k3_kw["exact"], presorted=k3_kw.get("presorted", False)))
    k3_bound_ms, _ = bound(*k3_cost(plan, values.shape[1], values.element_size()))
    vals32 = values.float()
    k3_lib_ms = device_ms(lambda: torch.zeros((plan.num_segments, values.shape[1]),
                                              device=dev).index_add_(
        0, seen["gather"].flat_indices, vals32), samples=10, reps=5)

    boots = {kind: wire_loop.boot_binary(kind, "cuda", os.path.join(out_dir, f"boot_{kind}"))
             for kind in ("scheduler", "trainer")}
    for kind in boots:
        shutil.rmtree(os.path.join(out_dir, f"boot_{kind}"), ignore_errors=True)

    dl, tr, pc, k1 = (summary[k] for k in ("downloads", "train_round", "parent_choice", "k1"))
    out = {
        **summary,
        "wall_seconds": wall_s, "kernel_launches": launches, "gat_steps": seen["gat_steps"],
        "sheds": sheds_since(sheds0),
        "k1": {**k1, "max_err_scaled": k1_err, "tol_scaled": K1_TOL,
               "flushes_checked": len(seen["flushes"]), "ms_128": k1_ms,
               "plain_ms_128": k1_plain_ms, "bound_ms_128": k1_bound_ms},
        "k3": {"rows": int(values.shape[0]), "d": int(values.shape[1]),
               "segments": plan.num_segments, "max_abs_err": k3_err, "max_abs_want": k3_max,
               "tol_relative": K3_TOL, "ms": k3_ms, "plain_ms": k3_plain_ms,
               "bound_ms": k3_bound_ms, "index_add_ms": k3_lib_ms},
        "boots": {kind: {k: b[k] for k in ("rc", "url", "response", "seconds_to_url",
                                           "seconds_to_exit")}
                  for kind, b in boots.items()},
    }
    emit({"phase": "wire_loop", **out})
    check(dl["downloads"] >= WIRE_DOWNLOADS and summary["hosts"] == SWARM_HOSTS,
          f"{dl['downloads']} downloads of {summary['hosts']} hosts")
    check(launches["fused_gather_mlp_score"] > 0, "K1 never launched on the wire path")
    check(k1["launches"] == k1["fused_flushes"] == launches["fused_gather_mlp_score"],
          f"K1 launches {k1['launches']} / {launches['fused_gather_mlp_score']} != the "
          f"batcher's fused flushes {k1['fused_flushes']} before the swap")
    # The round's MLP is standardized, which K1 does not run: the
    # subscription serves it on the host (cli.scheduler.k1_installs).
    check(pc["installed_standardized"] and k1["launches_after_swap"] == 0,
          f"the trained MLP (standardized: {pc['installed_standardized']}) launched K1 "
          f"{k1['launches_after_swap']} times after the swap")
    check(k1["batcher_fallbacks"] == 0 and k1["rule_degrades"] == 0,
          f"batcher fallbacks {k1['batcher_fallbacks']}, degrades {k1['rule_degrades']}")
    check(k1_err <= K1_TOL, f"K1 off its plain version by {k1_err} (scaled) on wire flushes")
    check(tr["error"] is None, f"the trainer's round failed: {tr['error']}")
    check(tr["rows_staged"] == tr["rows_written"] and tr["rows_written"]["topology"] > 0,
          f"rows staged {tr['rows_staged']} != rows written {tr['rows_written']}")
    for name, m in tr["metrics"].items():
        check(m["mae"] < tr["mean_predictor_mae"], f"{name} validation MAE {m['mae']} not "
              f"below the mean predictor's {tr['mean_predictor_mae']}")
    check(seen["gat_steps"] and launches["segment_sum"] == sum(seen["gat_steps"]),
          f"K3 launches {launches['segment_sum']} != GAT steps {seen['gat_steps']}")
    check(bool(torch.isfinite(got).all()) and (want != 0).any().item(),
          "K3 on the wire GAT input: non-finite or all zero")
    check(k3_err <= K3_TOL * k3_max, f"K3 off its plain version by {k3_err} on the wire "
          f"GAT input (max |sum| {k3_max})")
    check(pc["installed_scorer"] == "MLPScorer", f"installed {pc['installed_scorer']}")
    for arm in ("k1_seed_scorer", "installed", "rule"):
        check(pc[arm]["trials_with_parents"] == pc[arm]["trials"],
              f"{arm}: {pc[arm]['trials_with_parents']} of {pc[arm]['trials']} trials "
              "answered with parents")
    check(pc["installed"]["mb_s"] > pc["rule"]["mb_s"],
          f"the installed MLP's {pc['installed']['mb_s']} MB/s not above the rules' "
          f"{pc['rule']['mb_s']}")
    for kind, b in boots.items():
        check(b["rc"] == 0, f"{kind} serve mode exited {b['rc']} on SIGINT: {b['stderr']}")
    check(boots["scheduler"]["response"].get("protocol", {}).get("negotiated") == 2,
          f"scheduler boot answer {boots['scheduler']['response']}")
    check(str(boots["trainer"]["response"].get("session", "")).startswith("sess-"),
          f"trainer boot answer {boots['trainer']['response']}")
    return out, launches


def wire_lifecycle_phase(torch, dev, seed, out_dir):
    """Phase 17: the self-driving lifecycle over real sockets
    (``bench/wire_loop --lifecycle``).  Returns (summary, launches)."""
    from dragonfly2_tpu_torch.bench import wire_loop

    seen = {"flushes": []}
    work = os.path.join(out_dir, "wire_lifecycle")
    shutil.rmtree(work, ignore_errors=True)
    args = wire_loop.parse_args([
        "--lifecycle", "--hosts", str(SWARM_HOSTS), "--downloads", str(LC_DOWNLOAD_CAP),
        "--tasks", str(SWARM_TASKS), "--clients", str(WIRE_CLIENTS),
        "--trials", str(WIRE_TRIALS), "--train-interval", str(LC_TRAIN_INTERVAL),
        "--lifecycle-interval", str(LC_DAEMON_INTERVAL),
        "--report-interval", str(LC_REPORT_INTERVAL),
        "--timeout", str(LC_TIMEOUT), "--seed", str(seed), "--out", work, "--device", "cuda",
    ])
    reset_kernel_counts()
    sheds0 = shed_counts()
    t0 = time.perf_counter()
    with keep_k1_flushes(seen):
        summary = wire_loop.run(args, log=lambda line: print(line, flush=True))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernel_counts()
    shutil.rmtree(work, ignore_errors=True)
    k1_err, k1_ms, k1_plain_ms, k1_bound_ms = k1_on_flushes(
        torch, dev, seen, k1_save_dir(out_dir), "wire_lifecycle")

    walk, install, rows, k1, pc = (summary[k] for k in (
        "walk", "install", "rows", "k1", "parent_choice"))
    out = {**summary, "wall_seconds": wall_s, "kernel_launches": launches,
           "sheds": sheds_since(sheds0),
           "k1": {**k1, "max_err_scaled": k1_err, "tol_scaled": K1_TOL,
                  "flushes_checked": len(seen["flushes"]), "ms_128": k1_ms,
                  "plain_ms_128": k1_plain_ms, "bound_ms_128": k1_bound_ms}}
    emit({"phase": "wire_lifecycle", **out})
    version = walk["version"]
    check(walk["sampled_phases"] == ["shadow", "canary", "active"],
          f"v{version}'s rollout row read over REST: {walk['sampled_phases']}")
    mine = [d["decision"] for d in walk["decisions"] if d["version"] == version]
    check(mine[-1] == "promote" and "advance" in mine and "rollback" not in mine,
          f"the controller's decisions for v{version}: {mine}")
    check(walk["activate_posts"] == 0, f"{walk['activate_posts']} :activate calls")
    check(walk["loop_start_to_shadow_s"] > 0,
          "the candidate entered SHADOW before the seed scorer's parent choice ended")
    # SHADOW: the shadow engine and no canary route; CANARY: both, at 10 %.
    shadow, canary = ({"shadow": True, "canary_percent": p} for p in (None, 10))
    serving = walk["serving"]
    check(serving[:2] == [shadow, canary] and all(x in (shadow, canary) for x in serving),
          f"what the evaluator held for v{version}: {serving}")
    check(install["installed_version"] == install["active_version"] == version
          and install["installed_scorer"] == "MLPScorer" and install["active_is_daemons"],
          f"installed {install}")
    check(install["flushes_checked"] > 0 and install["scores_equal_registry_artifact"],
          "served scores after the install differ from the registry artifact's")
    check(rows["fed_to_daemon"] == rows["staged_download_rows"] > 0
          and rows["dropped_by_daemon"] == 0,
          f"rows fed to the daemon {rows['fed_to_daemon']} ({rows['dropped_by_daemon']} "
          f"dropped) != download rows uploaded {rows['staged_download_rows']}")
    check(rows["shadow_rows_on_disk"] == rows["shadow_rows_logged"]
          == rows["shadow_rows_read_back"] > 0
          and 0 < max(rows["reporter_reads"]) <= rows["shadow_rows_on_disk"],
          f"shadow log rows: {rows}")
    check(summary["daemon"]["device"].startswith("cuda") and summary["daemon"]["steps"] > 0,
          f"the daemon's trainer: {summary['daemon']}")
    check(launches["fused_gather_mlp_score"] == k1["launches"] == k1["fused_flushes"] > 0,
          f"K1 launches {launches['fused_gather_mlp_score']} / {k1['launches']} != the "
          f"fused flushes before the install {k1['fused_flushes']}")
    # The daemon's artifacts are standardized, which K1 does not run: the
    # subscription serves them on the host (cli.scheduler.k1_installs).
    check(install["installed_standardized"]
          and k1["launches_after_swap"] == k1["fused_flushes_after_swap"] == 0,
          f"the daemon's model (standardized: {install['installed_standardized']}) "
          f"launched K1 {k1['launches_after_swap']} times after the install")
    check(k1["batcher_fallbacks"] == 0 and k1["rule_degrades"] == 0,
          f"batcher fallbacks {k1['batcher_fallbacks']}, degrades {k1['rule_degrades']}")
    check(k1_err <= K1_TOL, f"K1 off its plain version by {k1_err} (scaled) on wire flushes")
    check(launches["segment_sum"] == 0, "K3 launched: the batch round has no topology rows")
    for arm in ("k1_seed_scorer", "installed", "rule"):
        check(pc[arm]["trials_with_parents"] == pc[arm]["trials"],
              f"{arm}: {pc[arm]['trials_with_parents']} of {pc[arm]['trials']} trials "
              "answered with parents")
    return out, launches


# ---------------------------------------------------------------------------
# Multi-device training on torch.distributed
# ---------------------------------------------------------------------------


def _md_hop_runs(torch, mesh, work, n_edges, epochs, seed):
    """train_hop_ranker at the flagship's width on ``mesh``, replicated and
    node-sharded; each run's losses, validation MAE, step ms p50, peak
    memory and collectives."""
    from dragonfly2_tpu_torch.models.hop import HopConfig
    from dragonfly2_tpu_torch.parallel import mesh as pm
    from dragonfly2_tpu_torch.trainer.train import TrainConfig, train_hop_ranker

    runs = {}
    for mode in ("replicated", "model"):
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        pm.reset_collective_counts()
        t0 = time.perf_counter()
        state, metrics, history = train_hop_ranker(
            work["node_feats"], work["table"], work["src"][:n_edges], work["dst"][:n_edges],
            work["target"][:n_edges], model_config=HopConfig(hidden=HOP_HIDDEN),
            config=TrainConfig(epochs=epochs, warmup_steps=2, log_every=1, seed=seed),
            batch_size=GAT_BATCH, mesh=mesh, node_sharding=mode,
        )
        torch.cuda.synchronize(mesh.device)
        runs[mode] = {
            "seconds": time.perf_counter() - t0, "steps": state.step,
            "losses": [h["loss"] for h in history], "mae": metrics.mae,
            "step_ms_p50": step_p50_of(history),
            "peak_memory_gib": torch.cuda.max_memory_allocated(mesh.device) / 2**30,
            "collectives": dict(pm.COLLECTIVES),
        }
    return runs


def _multidevice_rank(rank, dev, work, seed):
    """Phase 18(b), one of four ranks on one card in a gloo group: the
    halo precompute against the replicated one, then MD_STEPS_B flagship
    steps replicated and node-sharded on a (2 data x 2 model) mesh."""
    import torch

    from dragonfly2_tpu_torch.models.hop import precompute_hop_features
    from dragonfly2_tpu_torch.parallel import mesh as pm
    from dragonfly2_tpu_torch.parallel.graph_sharding import (
        NodeShard, build_halo_plan, precompute_hop_features_sharded,
    )

    mesh = pm.create_mesh(pm.MeshSpec(data=2, model=2), device=dev, backend="gloo")
    table, nf = work["table"], work["node_feats"]
    t0 = time.perf_counter()
    plan = build_halo_plan(table, mesh, axis=pm.MODEL_AXIS)
    plan_s = time.perf_counter() - t0
    got = precompute_hop_features_sharded(mesh, nf, table, plan, hops=2, axis=pm.MODEL_AXIS)
    want = NodeShard(mesh, pm.MODEL_AXIS, GAT_NODES).block(
        precompute_hop_features(torch.from_numpy(nf).to(dev), table.to(dev), hops=2))
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    del got, want
    n, S, H, D = plan.n_shards, plan.shard_size, plan.halo, nf.shape[1]
    # One model group's traffic per hop: every rank sends n x H rows of D
    # float32 (the halo all-to-all); a full all-gather brings every rank
    # the n - 1 other blocks.
    halo = {"shards": n, "S": S, "H": H, "D": D, "plan_seconds": plan_s,
            "halo_bytes_per_hop": n * n * H * D * 4,
            "all_gather_bytes_per_hop": n * (n - 1) * S * D * 4}
    # MD_STEPS_B steps: the train split holds MD_STEPS_B full batches.
    n_edges = -(-MD_STEPS_B * GAT_BATCH * 10 // 9)
    runs = _md_hop_runs(torch, mesh, work, n_edges, 1, seed)
    return {"coord": {a: mesh.coord(a) for a in (pm.DATA_AXIS, pm.MODEL_AXIS)},
            "precompute_err": err, "precompute_scale": scale, "halo": halo, "runs": runs}


def multidevice_phase(torch, dev, seed, out_dir, work, gat, hop):
    """Phase 18: the mesh path at the flagship's width.  (a) NCCL, world 1,
    in this process; (b) four gloo ranks on the one card.  Returns (its
    summary, its K3 launches, K3's error on the path's input)."""
    import torch.distributed as dist

    from dragonfly2_tpu_torch.models.gnn import GNNConfig
    from dragonfly2_tpu_torch.models.hop import Embed, HopConfig, precompute_hop_features
    from dragonfly2_tpu_torch.ops import segment
    from dragonfly2_tpu_torch.ops.segment import _segment_sum_plain, make_neighbor_gather
    from dragonfly2_tpu_torch.parallel import mesh as pm
    from dragonfly2_tpu_torch.parallel.dryrun import run_ranks
    from dragonfly2_tpu_torch.parallel.graph_sharding import (
        build_halo_plan, precompute_hop_features_sharded,
    )
    from dragonfly2_tpu_torch.trainer import train as train_mod
    from dragonfly2_tpu_torch.trainer.train import TrainConfig

    t_phase = time.perf_counter()
    store_dir = os.path.join(out_dir, "multidevice_store")
    shutil.rmtree(store_dir, ignore_errors=True)
    os.makedirs(store_dir)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store_dir, "a"), 1),
                            rank=0, world_size=1)
    try:
        mesh = pm.create_mesh(pm.MeshSpec(data=1, model=1), device=dev)
        table, nf = work["table"], work["node_feats"]
        mcfg = HopConfig(hidden=HOP_HIDDEN)
        # A node-sharded embedding is drawn whole on the host generator
        # and the rank keeps its block: the draw's host cost.
        t0 = time.perf_counter()
        drawn = Embed(GAT_NODES, mcfg.node_embed_dim, torch.Generator().manual_seed(seed))
        embed_draw = {"ms": (time.perf_counter() - t0) * 1e3,
                      "bytes": drawn.embedding.numel() * drawn.embedding.element_size()}
        del drawn
        plan = build_halo_plan(table, mesh, axis=pm.MODEL_AXIS)
        got = precompute_hop_features_sharded(mesh, nf, table, plan, hops=mcfg.hops,
                                              axis=pm.MODEL_AXIS)
        want = precompute_hop_features(torch.from_numpy(nf).to(dev), table.to(dev),
                                       hops=mcfg.hops)
        pre_err = float((got - want).abs().max())
        pre_scale = max(1.0, float(want.abs().max()))
        del got, want

        # The flagship, node-sharded, phase 10's 18 steps.
        hop_runs = _md_hop_runs(torch, mesh, work, GAT_EDGES, GAT_EPOCHS, seed)
        hop_run = hop_runs["model"]

        # The GAT data-parallel with the K3 gather: K3 is its backward on
        # this rank's slice.  A tap keeps the run's first K3 input.
        seen = {}

        def keep_first_k3(fn):
            def wrapped(values, plan, **kw):
                seen.setdefault("k3", (values.detach().clone(), plan, kw))
                return fn(values, plan, **kw)
            return wrapped

        gather = make_neighbor_gather(table.indices, GAT_NODES, device=dev)
        gcfg = GNNConfig(gather_fn=gather)
        reset_kernel_counts()
        pm.reset_collective_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with tapped(segment, "segment_sum_bucketed", keep_first_k3):
            gstate, gmetrics, ghistory = train_mod.train_gat_ranker(
                nf, table, work["src"], work["dst"], work["target"], model_config=gcfg,
                config=TrainConfig(epochs=GAT_EPOCHS, warmup_steps=2, log_every=1, seed=seed),
                batch_size=GAT_BATCH, mesh=mesh,
            )
            torch.cuda.synchronize()
        gat_s = time.perf_counter() - t0
        gat_launches = kernel_counts()
        gat_collectives = dict(pm.COLLECTIVES)
        gat_peak = torch.cuda.max_memory_allocated() / 2**30
        values, k3_plan, k3_kw = seen["k3"]
        k3_got = segment.segment_sum_bucketed(values, k3_plan, **k3_kw)
        torch.cuda.synchronize()
        k3_want = _segment_sum_plain(values, k3_plan, exact=k3_kw["exact"],
                                     presorted=k3_kw.get("presorted", False))
        k3_err = float((k3_got - k3_want).abs().max())
        k3_max = float(k3_want.abs().max())
        del values, k3_got, k3_want
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    a_s = time.perf_counter() - t_phase

    # (b) four ranks on the one card: NCCL refuses two ranks on one device.
    t1 = time.perf_counter()
    ranks = run_ranks(_multidevice_rank, MD_RANKS, device="cuda:0", backend="gloo",
                      args=(work, seed))
    b_s = time.perf_counter() - t1

    gat_losses = [h["loss"] for h in ghistory]
    steps18 = len(hop["losses_18"])
    summary = {
        "seconds": time.perf_counter() - t_phase, "a_seconds": a_s, "b_seconds": b_s,
        "a": {
            "precompute_max_abs_err": pre_err, "precompute_scale": pre_scale,
            "embed_whole_draw": embed_draw, "hop": hop_run, "hop_replicated_on_mesh": hop_runs["replicated"],
            "hop_step_ms_p50_without_mesh": hop["step_ms_p50_18"],
            "hop_loss_max_rel_vs_phase10": max(
                abs(a - b) / abs(b) for a, b in zip(hop_run["losses"], hop["losses_18"])),
            "hop_mae_phase10": hop["metrics_after_18_steps"]["mae"],
            "gat": {"seconds": gat_s, "steps": gstate.step, "losses": gat_losses,
                    "mae": gmetrics.mae, "step_ms_p50": step_p50_of(ghistory),
                    "peak_memory_gib": gat_peak, "collectives": gat_collectives,
                    "kernel_launches": gat_launches, "k3_max_abs_err": k3_err,
                    "k3_max_abs_want": k3_max},
            "gat_step_ms_p50_without_mesh": gat["step_ms_p50"],
            "gat_loss_max_rel_vs_phase6": max(
                abs(a - b) / abs(b) for a, b in zip(gat_losses, gat["losses"])),
        },
        "b": ranks,
    }
    emit({"phase": "multidevice", **summary})

    # (a) checks.
    check(pre_err <= MD_PRE_TOL * pre_scale,
          f"sharded precompute off the replicated one by {pre_err} (scale {pre_scale})")
    check(hop_run["steps"] == steps18 and len(hop_run["losses"]) == steps18,
          f"{hop_run['steps']} node-sharded flagship steps, phase 10 took {steps18}")
    check(summary["a"]["hop_loss_max_rel_vs_phase10"] <= MD_LOSS_RTOL,
          f"node-sharded flagship losses off phase 10's: {summary['a']['hop_loss_max_rel_vs_phase10']}")
    check(abs(hop_run["mae"] - summary["a"]["hop_mae_phase10"]) <= MD_MAE_TOL,
          f"node-sharded flagship MAE {hop_run['mae']} vs phase 10's "
          f"{summary['a']['hop_mae_phase10']}")
    # No shortcut at world 1: per step the lookup, the replicated
    # gradients, the embedding's gradient and the clip's norm; the
    # validation lookup; one halo all-to-all per hop.
    want_hop = {**{k: 0 for k in pm.COLLECTIVES}, "all_reduce": 4 * steps18 + 1,
                "all_to_all": mcfg.hops}
    check(hop_run["collectives"] == want_hop,
          f"node-sharded flagship collectives {hop_run['collectives']} != {want_hop}")
    want_repl = {**{k: 0 for k in pm.COLLECTIVES}, "all_reduce": steps18}
    check(hop_runs["replicated"]["collectives"] == want_repl,
          f"replicated flagship collectives {hop_runs['replicated']['collectives']} != {want_repl}")
    layers = gcfg.num_layers
    check(gstate.step == steps18, f"{gstate.step} mesh GAT steps")
    check(gat_launches["segment_sum"] == gstate.step * layers,
          f"K3 launches {gat_launches['segment_sum']} != {gstate.step} steps x {layers} layers")
    check(gat_collectives == want_repl,
          f"mesh GAT collectives {gat_collectives} != {want_repl}")
    check(k3_max > 0 and k3_err <= K3_TOL * k3_max,
          f"K3 off its plain version by {k3_err} on the mesh GAT's input (max |sum| {k3_max})")
    check(summary["a"]["gat_loss_max_rel_vs_phase6"] <= STEP_LOSS_TOL,
          f"mesh GAT losses off phase 6's: {summary['a']['gat_loss_max_rel_vs_phase6']}")
    # (b) checks.
    for r in ranks:
        check(r["precompute_err"] <= MD_PRE_TOL * r["precompute_scale"],
              f"rank {r['coord']}: halo precompute off by {r['precompute_err']}")
        rep, mp = r["runs"]["replicated"], r["runs"]["model"]
        check(rep["steps"] == mp["steps"] == MD_STEPS_B,
              f"rank {r['coord']}: {rep['steps']} / {mp['steps']} steps")
        rel = max(abs(a - b) / abs(b) for a, b in zip(mp["losses"], rep["losses"]))
        check(rel <= MD_LOSS_RTOL, f"rank {r['coord']}: node-sharded losses off by {rel}")
        check(mp["losses"] == ranks[0]["runs"]["model"]["losses"],
              f"rank {r['coord']}: losses differ across ranks")
    check(summary["seconds"] <= MD_SECONDS, f"phase 18 took {summary['seconds']} s")
    return summary, gat_launches["segment_sum"], k3_err


# ---------------------------------------------------------------------------
# Tracing, telemetry and tenant QoS on the K1 serving path
# ---------------------------------------------------------------------------


def telemetry_qos_phase(torch, dev, seed, out_dir):
    """Phase 19: the K1 serving path with the tenant QoS policy, the flight
    recorder, the metric journal and the SLO engine.  Returns (summary,
    launches)."""
    import argparse

    from dragonfly2_tpu_torch.cli.common import (
        init_flight_recorder, init_telemetry, stop_telemetry)
    from dragonfly2_tpu_torch.cli.scheduler import SchedulerConfig, build
    from dragonfly2_tpu_torch.config.schema import TracingSection
    from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
    from dragonfly2_tpu_torch.rpc.scheduler_server import SchedulerRPCAdapter, host_to_wire
    from dragonfly2_tpu_torch.scheduler import ScorerBatcher
    from dragonfly2_tpu_torch.scheduler import metrics as smetrics
    from dragonfly2_tpu_torch.sim.swarm import host_from_latent
    from dragonfly2_tpu_torch.trainer.export import MLPScorer, scorer_to_bytes
    from dragonfly2_tpu_torch.utils import tracing
    from dragonfly2_tpu_torch.utils.metric_journal import replay_metric_journal
    from dragonfly2_tpu_torch.utils.metrics import merge_sketch_states

    def flush_observations():
        return smetrics.EVAL_FLUSH_SECONDS.aggregate_state()["total"]

    work = os.path.join(out_dir, "telemetry_qos")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_phase = time.perf_counter()
    cfg = SchedulerConfig()
    cfg.storage.dir = os.path.join(work, "records")
    cfg.scheduling.algorithm = "ml"
    cfg.scheduling.eval_feature_cache_hosts = STORE_SLOTS
    cfg.scheduling.eval_batch_linger_ms = 1.5
    cfg.scheduling.retry_interval_s = 0.0
    cfg.telemetry.journal_path = os.path.join(work, "scheduler.dfmj")
    cfg.telemetry.journal_interval_s = 1.0
    cfg.telemetry.slo_interval_s = 1.0
    cfg.telemetry.slos = [TQ_SLO]
    blob = scorer_to_bytes(MLPScorer(weights=weights_from_seed(seed)))
    service = build(cfg, device=dev, scorer_blob=blob, rng=random.Random(seed),
                    seed_trigger=False)  # synthetic seed hosts: no trigger
    batcher = service.scheduling.evaluator.batcher
    service.on_qos_config({"tenant_qos": {
        t: {"tenant_class": c, "weight": w} for t, (c, w) in TQ_TENANTS.items()}})
    check(service.qos_policy is not None and batcher._qos_policy is service.qos_policy,
          "on_qos_config did not install the policy in the batcher")
    cluster = SyntheticCluster(num_hosts=N_HOSTS, seed=seed)
    hosts = [host_from_latent(lh) for lh in cluster.hosts]
    for h in hosts:
        service.announce_host(h)
    urls = warm_tasks(service, cluster, hosts, n_tasks=TQ_TASKS, hosts_per_task=TQ_WARM)
    warm_s = time.perf_counter() - t_phase
    answer = SchedulerRPCAdapter(service).announce_host(
        {"host": host_to_wire(hosts[0]), "tenant": "t-gold"})

    drains, groups, seen = [], [0], {"flushes": []}

    def keep_drains(fn):
        def wrapped(self):
            batch = fn(self)
            if self is batcher and batch:
                rows = {}
                for r in batch:
                    rows[r.tenant] = rows.get(r.tenant, 0) + r.rows
                drains.append(rows)
            return batch
        return wrapped

    def count_groups(fn):
        def wrapped(self, batch, scorer):
            if self is batcher:
                groups[0] += 1
            return fn(self, batch, scorer)
        return wrapped

    args = argparse.Namespace(trace_log=None, metric_journal=None, _prog="scheduler")
    exporter, service_name = tracing.default_tracer.exporter, tracing.default_tracer.service
    n_req = THREADS * PER_THREAD
    journal, engine = init_telemetry(args, cfg.telemetry, "scheduler")
    runs = []
    reset_kernel_counts()
    calls0 = batcher.scorer_calls
    try:
        with tapped(ScorerBatcher, "_drain_locked", keep_drains), \
                tapped(ScorerBatcher, "_dispatch_group", count_groups), \
                keep_k1_flushes(seen):
            for i, arm in enumerate(TQ_ORDER):
                durable = None
                if TQ_RATES[arm] is None:
                    tracing.set_enabled(False)
                else:
                    durable = init_flight_recorder(args, TracingSection(
                        log_path=os.path.join(work, f"{arm}{i}.dftrace"),
                        sample_rate=TQ_RATES[arm]), "scheduler")
                d0, g0, f0 = len(drains), groups[0], flush_observations()
                _, timing, kinds = serve_requests(
                    service, hosts, urls, hosts_per_task=TQ_WARM, threads=THREADS,
                    per_thread=PER_THREAD, first=i * n_req, tenants=list(TQ_TENANTS))
                tracing.set_enabled(True)
                runs.append({"arm": arm, "timing": timing, "schedule_kinds": kinds,
                             "drains": drains[d0:], "dispatch_groups": groups[0] - g0,
                             "flush_observations": flush_observations() - f0,
                             "durable": durable})
                if durable is not None:
                    durable.close()
    finally:
        tracing.default_tracer.exporter = exporter
        tracing.default_tracer.service = service_name
        tracing.set_enabled(True)
    torch.cuda.synchronize()
    launches = kernel_counts()
    calls = batcher.scorer_calls - calls0
    deadline = time.monotonic() + 5.0
    while not engine.state()["slos"] and time.monotonic() < deadline:
        time.sleep(0.1)
    slo_state = engine.state()["slos"]
    stop_telemetry(journal, engine)
    snaps, journal_stats = replay_metric_journal(cfg.telemetry.journal_path)
    live_flushes = flush_observations()
    journal_flushes = merge_sketch_states([
        st for _, st in snaps[-1]["metrics"]["scheduler_eval_flush_seconds"]["series"]
    ])["total"] if snaps else -1
    k1_err, k1_ms, k1_plain_ms, k1_bound_ms = k1_on_flushes(
        torch, dev, seen, k1_save_dir(out_dir), "telemetry_qos")

    rows_by_tenant = {}
    for run in runs:
        drained = run.pop("drains")
        run.update({"flushes": len(drained),
                    "rows_drained": sum(sum(d.values()) for d in drained),
                    "flushes_two_or_more_lanes": sum(len(d) >= 2 for d in drained),
                    "announce_rate_per_s": n_req / run["timing"]["wall"]})
        for d in drained:
            for t, n in d.items():
                rows_by_tenant[t] = rows_by_tenant.get(t, 0) + n
        durable = run.pop("durable")
        if durable is None:
            continue
        reqs, stats = tracing.replay_trace_log(durable.path)
        spans = [sp for sp in tracing.log_spans(reqs) if sp["name"] == "scheduler/eval.flush"]
        rows = [int(a["value"]["intValue"]) for sp in spans for a in sp["attributes"]
                if a["key"] == "rows"]
        run.update({"log": stats, "exported": durable.exported,
                    "sampled_out": durable.sampled_out, "flush_spans_replayed": len(spans),
                    "span_rows": sum(rows), "reader": read_trace_log(durable.path)})
    arms = {}
    for arm, rate in TQ_RATES.items():
        mine = [r for r in runs if r["arm"] == arm]
        pooled = {k: sum((r["timing"][k] for r in mine), [])
                  for k in ("register", "evaluate", "flush")}
        pooled["wall"] = sum(r["timing"]["wall"] for r in mine)
        arms[arm] = {"sample_rate": rate, **summarize(pooled, n_req * len(mine)),
                     "runs": [{k: v for k, v in r.items() if k not in ("arm", "timing")}
                              for r in mine]}
    total_rows = sum(rows_by_tenant.values())
    out = {
        "seconds": time.perf_counter() - t_phase, "warm_seconds": warm_s, "arms": arms,
        "tenant_row_share": {t: n / total_rows for t, n in sorted(rows_by_tenant.items())},
        "k1_launches": launches["fused_gather_mlp_score"], "scorer_calls": calls,
        "batcher_fallbacks": batcher.fallbacks, "slo": slo_state,
        "journal": {**journal_stats, "final_flush_count": journal_flushes,
                    "live_flush_count": live_flushes},
        "announce_tenant_qos": answer.get("tenant_qos"),
        "k1": {"max_err_scaled": k1_err, "tol_scaled": K1_TOL,
               "flushes_checked": len(seen["flushes"]), "ms_128": k1_ms,
               "plain_ms_128": k1_plain_ms, "bound_ms_128": k1_bound_ms},
    }
    emit({"phase": "telemetry_qos", **out})
    shutil.rmtree(cfg.storage.dir, ignore_errors=True)

    for i, run in enumerate(runs):
        what = f"run {i} ({run['arm']})"
        check(sum(run["schedule_kinds"].values()) == n_req
              and "NONE" not in run["schedule_kinds"],
              f"{what}: answers {run['schedule_kinds']}")
        check(run["flush_observations"] == run["dispatch_groups"] == run["flushes"] > 0,
              f"{what}: flush observations {run['flush_observations']}, dispatch groups "
              f"{run['dispatch_groups']}, drains {run['flushes']}")
        if run["arm"] == "off":
            continue
        check(run["log"]["frames"] == run["exported"] and run["log"]["corrupt"] == 0
              and not run["log"]["torn_tail"]
              and run["exported"] + run["sampled_out"] == run["flush_observations"],
              f"{what}: log {run['log']}, exported {run['exported']}, sampled out "
              f"{run['sampled_out']}, flushes {run['flush_observations']}")
        if run["arm"] == "full":
            check(run["flush_spans_replayed"] == run["exported"]
                  == run["flush_observations"] == run["dispatch_groups"],
                  f"{what}: flush spans replayed {run['flush_spans_replayed']}, exported "
                  f"{run['exported']}, flush observations {run['flush_observations']}, "
                  f"dispatch groups {run['dispatch_groups']}")
            check(run["span_rows"] == run["rows_drained"],
                  f"{what}: span rows {run['span_rows']} != rows drained "
                  f"{run['rows_drained']}")
        reader = run["reader"]
        check(reader["flush_spans"] == run["flush_spans_replayed"] and reader["corrupt"] == 0
              and reader["frames"] == run["log"]["frames"],
              f"{what}: the reader assembled {reader['flush_spans']} flush spans of "
              f"{run['flush_spans_replayed']} replayed ({reader})")
    check(launches["fused_gather_mlp_score"] == calls > 0,
          f"K1 launches {launches['fused_gather_mlp_score']} != the batcher's scorer calls "
          f"{calls}")
    check(launches["segment_sum"] == 0 and launches["rule_weighted_sum"] == 0,
          f"another kernel launched on the serving path: {launches}")
    check(batcher.fallbacks == 0, f"{batcher.fallbacks} batcher fallbacks")
    check(k1_err <= K1_TOL, f"K1 off its plain version by {k1_err} (scaled) on phase 19's "
          "flushes")
    check(len(seen["flushes"]) == WIRE_K1_FLUSHES, f"{len(seen['flushes'])} flushes kept")
    check(journal_stats["corrupt"] == 0 and journal_flushes == live_flushes,
          f"the journal's last flush count {journal_flushes} != the registry's "
          f"{live_flushes} ({journal_stats})")
    check(bool(slo_state) and slo_state[0]["samples"] >= 1,
          f"the SLO engine evaluated no window: {slo_state}")
    check(answer.get("tenant_qos") == service.qos_policy.to_payload(),
          f"the announce answer's tenant_qos: {answer.get('tenant_qos')}")
    return out, launches


def peer_swarm_phase(torch, dev, seed, out_dir):
    """Phase 20: the peer daemon's download path (``bench/peer_swarm``),
    K1 ranking the daemons' parents: at the defaults (the native engine),
    then on the Python store and server with ``native_fetch`` off.
    Returns (the native arm's summary with the Python arm's under
    ``python_arm``, the launches of both arms)."""
    from dragonfly2_tpu_torch.bench import peer_swarm

    arms, launches = {}, {}
    for arm, extra in (("native", []), ("python", ["--python-engine"])):
        seen = {"flushes": []}
        args = peer_swarm.parse_args([
            "--daemons", str(PS_DAEMONS), "--size-mib", str(PS_SIZE_MIB),
            "--seed", str(seed), "--out", out_dir, "--device", "cuda", *extra,
        ])
        reset_kernel_counts()
        sheds0 = shed_counts()
        t0 = time.perf_counter()
        with keep_k1_flushes(seen):
            summary = peer_swarm.run(args, log=lambda line: print(line, flush=True))
        torch.cuda.synchronize()
        arm_launches = kernel_counts()
        phase_s = time.perf_counter() - t0
        check(len(seen["flushes"]) > 0, f"no K1 flush on the peer swarm's path ({arm} arm)")
        k1_err, k1_ms, k1_plain_ms, k1_bound_ms = k1_on_flushes(
            torch, dev, seen, k1_save_dir(out_dir), f"peer_swarm_{arm}")
        out = {
            **summary, "arm": arm, "phase_seconds": phase_s, "kernel_launches": arm_launches,
            "sheds": sheds_since(sheds0),
            "k1": {"launches": arm_launches["fused_gather_mlp_score"],
                   "scorer_calls": summary["scorer_calls"], "max_err_scaled": k1_err,
                   "tol_scaled": K1_TOL, "flushes_checked": len(seen["flushes"]),
                   "ms_128": k1_ms, "us_128": k1_ms * 1e3, "plain_ms_128": k1_plain_ms,
                   "bound_ms_128": k1_bound_ms},
        }
        emit({"phase": "peer_swarm", **out})
        for name, ok in summary["checks"].items():
            check(ok, f"peer swarm check {name} failed ({arm} arm): {json.dumps(summary)}")
        if arm == "native":
            check_native_daemons(summary, "peer swarm")
        check(arm_launches["fused_gather_mlp_score"] == summary["scorer_calls"] > 0,
              f"K1 launches {arm_launches['fused_gather_mlp_score']} != the batcher's scorer "
              f"calls {summary['scorer_calls']} on the peer swarm ({arm} arm)")
        check(arm_launches["segment_sum"] == 0 and arm_launches["rule_weighted_sum"] == 0,
              f"another kernel launched on the peer swarm ({arm} arm): {arm_launches}")
        check(k1_err <= K1_TOL, f"K1 off its plain version by {k1_err} (scaled) on the peer "
              f"swarm's flushes ({arm} arm)")
        arms[arm] = out
        for name, n in arm_launches.items():
            launches[name] = launches.get(name, 0) + n
    # The two engines side by side at one configuration.
    emit({"phase": "peer_swarm_arms", **{arm: {
        "wall_seconds": o["wall_seconds"], "aggregate_mb_s": o["aggregate_mb_s"],
        "daemon_mb_s": o["daemon_mb_s"], "p2p_mb_s": o["p2p_mb_s"],
        "pieces_by_parent": o["pieces_by_parent"], "daemon0_p2p_share": o["daemon0_p2p_share"],
        "native_fetch_pieces": o["engine"]["native_fetch_pieces"],
        "sendfile_bytes": o["engine"]["sendfile_bytes"],
        "python_served_bytes": o["engine"]["python_served_bytes"],
        "batched_pieces": o["engine"]["batched_pieces"],
        "k1_launches": o["k1"]["launches"]} for arm, o in arms.items()}})
    native_out = arms["native"]
    native_out["python_arm"] = arms["python"]
    native_out["k1"]["launches_python_arm"] = arms["python"]["k1"]["launches"]
    native_out["k1"]["max_err_scaled"] = max(o["k1"]["max_err_scaled"] for o in arms.values())
    return native_out, launches


def preheat_phase(torch, dev, seed, out_dir):
    """Phase 21: preheat and the seed peer (``bench/preheat_swarm``), K1
    ranking seed parents, dynconfig reaching the scheduler live.
    Returns (summary, launches)."""
    from dragonfly2_tpu_torch.bench import preheat_swarm

    seen = {"flushes": []}
    args = preheat_swarm.parse_args([
        "--daemons", str(PH_DAEMONS), "--size-mib", str(PH_SIZE_MIB),
        "--cold-mib", str(PH_COLD_MIB), "--seed", str(seed), "--out", out_dir,
        "--device", "cuda",
    ])
    reset_kernel_counts()
    sheds0 = shed_counts()
    t0 = time.perf_counter()
    with keep_k1_flushes(seen):
        summary = preheat_swarm.run(args, log=lambda line: print(line, flush=True))
    sheds = sheds_since(sheds0)
    torch.cuda.synchronize()
    launches = kernel_counts()
    phase_s = time.perf_counter() - t0
    check(len(seen["flushes"]) > 0, "no K1 flush on the preheat path")
    # SUPER_SEED rows among the recorded flushes' parent slots: column 9
    # of each flush's mirror, on rows with any edge feature set (a pad
    # row's edge features are all 0 and its slot is 0).
    seed_rows = sum(int(((mat.float().cpu().numpy()[src, 9] == 1)
                         & (np.abs(edge).sum(axis=1) > 0)).sum())
                    for mat, (edge, src, _) in zip(seen["mirrors"], seen["flushes"]))
    k1_err, k1_ms, k1_plain_ms, k1_bound_ms = k1_on_flushes(
        torch, dev, seen, k1_save_dir(out_dir), "preheat")
    out = {
        **summary, "phase_seconds": phase_s, "kernel_launches": launches,
        "sheds": sheds,
        "k1": {"launches": launches["fused_gather_mlp_score"],
               "scorer_calls": summary["scorer_calls"], "max_err_scaled": k1_err,
               "tol_scaled": K1_TOL, "flushes_checked": len(seen["flushes"]),
               "super_seed_rows_in_flushes": seed_rows,
               "ms_128": k1_ms, "us_128": k1_ms * 1e3, "plain_ms_128": k1_plain_ms,
               "bound_ms_128": k1_bound_ms},
    }
    emit({"phase": "preheat_swarm", **out})
    for name, ok in summary["checks"].items():
        check(ok, f"preheat swarm check {name} failed: {json.dumps(summary)}")
    check_native_daemons(summary, "preheat swarm")
    check(launches["fused_gather_mlp_score"] == summary["scorer_calls"] > 0,
          f"K1 launches {launches['fused_gather_mlp_score']} != the batcher's scorer calls "
          f"{summary['scorer_calls']} on the preheat path")
    check(launches["segment_sum"] == 0 and launches["rule_weighted_sum"] == 0,
          f"another kernel launched on the preheat path: {launches}")
    check(seed_rows > 0, "no SUPER_SEED row (column 9) in a recorded K1 flush")
    check(k1_err <= K1_TOL, f"K1 off its plain version by {k1_err} (scaled) on the preheat "
          "path's flushes")
    return out, launches


def shard_fleet_phase(torch, dev, seed, out_dir):
    """Phase 22: the sharded scheduler fleet.  (a) the columnar fleet
    (``bench/fleet_swarm``, host-only: no kernel may launch), (b) three
    ``ml`` schedulers behind the manager's ring with daemons steering
    across them and the child shard SIGKILLed (``bench/shard_fleet``).
    K1's launches are counted in this process, so only the two
    in-process shards' launches are seen; the child's are its own.
    Returns (summary, launches of (b))."""
    from dragonfly2_tpu_torch.bench import fleet_swarm, shard_fleet

    # (a) the columnar fleet at BENCH_SW_r01.json's configuration.
    fargs = fleet_swarm.parse_args([f"--{k.replace('_', '-')}={v}" for k, v in SF_FLEET.items()])
    reset_kernel_counts()
    t0 = time.perf_counter()
    fleet = fleet_swarm.run(fargs)
    fleet_s = time.perf_counter() - t0
    fleet_launches = kernel_counts()
    arms, drill = fleet["arms"], fleet["membership_drill"]
    fleet_out = {
        "seconds": fleet_s, "config": fleet["config"], "speedup_shards": fleet["speedup_shards"],
        "announces_per_sec": {a: arms[a]["announces_per_sec"] for a in arms},
        "hosts_per_shard_max": {a: arms[a]["hosts_per_shard_max"] for a in arms},
        "bind_misses": {a: arms[a]["bind_misses"] for a in arms},
        "downloads_ok": {a: arms[a]["downloads_ok"] for a in arms},
        "downloads_failed": {a: arms[a]["downloads_failed"] for a in arms},
        "sheds": {a: arms[a]["sheds"] for a in arms},
        "kill_handoffs": drill.get("kill_handoffs"), "add_handoffs": drill.get("add_handoffs"),
        "downloads_after_kill": drill.get("downloads_after_kill"),
        "redirects_followed": drill.get("redirects_followed"),
        "kernel_launches": fleet_launches,
    }
    emit({"phase": "shard_fleet_columnar", **fleet_out})
    check(fleet["ok"] and drill.get("ran"), f"the columnar fleet's drill did not run: {drill}")
    check(all(arms[a]["downloads_failed"] == 0 for a in arms),
          f"columnar fleet downloads failed: {fleet_out['downloads_failed']}")
    check(drill["downloads_after_kill"] > 0, "no download completed after the shard kill")
    check(not any(fleet_launches.values()), f"a kernel launched on the host-only fleet: "
          f"{fleet_launches}")

    # (b) ml shards over the wire, K1 in each, the child SIGKILLed.
    seen = {"flushes": []}
    args = shard_fleet.parse_args([
        "--daemons", str(SK_DAEMONS), "--files", str(SK_FILES), "--size-mib", str(SK_SIZE_MIB),
        "--refresh-s", str(SK_REFRESH_S), "--seed", str(seed), "--out", out_dir,
        "--device", "cuda",
    ])
    reset_kernel_counts()
    sheds0 = shed_counts()
    t0 = time.perf_counter()
    with keep_k1_flushes(seen):
        summary = shard_fleet.run(args, log=lambda line: print(line, flush=True))
    torch.cuda.synchronize()
    launches = kernel_counts()
    phase_s = time.perf_counter() - t0
    check(len(seen["flushes"]) > 0, "no K1 flush on the in-process shards")
    k1_err, k1_ms, k1_plain_ms, k1_bound_ms = k1_on_flushes(
        torch, dev, seen, k1_save_dir(out_dir), "shard_fleet")
    out = {
        **summary, "phase_seconds": phase_s, "kernel_launches": launches,
        "sheds": sheds_since(sheds0),
        "k1": {"launches": launches["fused_gather_mlp_score"],
               "scorer_calls": summary["scorer_calls"], "max_err_scaled": k1_err,
               "tol_scaled": K1_TOL, "flushes_checked": len(seen["flushes"]),
               "ms_128": k1_ms, "us_128": k1_ms * 1e3, "plain_ms_128": k1_plain_ms,
               "bound_ms_128": k1_bound_ms},
    }
    emit({"phase": "shard_fleet", **out})
    for name, ok in summary["checks"].items():
        check(ok, f"shard fleet check {name} failed: {json.dumps(summary)}")
    check_native_daemons(summary, "shard fleet")
    check(launches["fused_gather_mlp_score"] == summary["scorer_calls"] > 0,
          f"K1 launches {launches['fused_gather_mlp_score']} != the in-process batchers' "
          f"scorer calls {summary['scorer_calls']} on the shard fleet")
    check(launches["segment_sum"] == 0 and launches["rule_weighted_sum"] == 0,
          f"another kernel launched on the shard fleet: {launches}")
    check(k1_err <= K1_TOL, f"K1 off its plain version by {k1_err} (scaled) on the shard "
          "fleet's flushes")
    return {"columnar": fleet_out, **out}, launches


def push_phase(torch, dev, seed, out_dir):
    """Phase 23: the push-reschedule path on the K1 serving path.
    Returns (summary, launches)."""
    import queue
    from collections import Counter

    from dragonfly2_tpu_torch.bench import k1_replay
    from dragonfly2_tpu_torch.cli.scheduler import SchedulerConfig, build
    from dragonfly2_tpu_torch.records.synthetic import PIECE_SIZE, SyntheticCluster
    from dragonfly2_tpu_torch.rpc.scheduler_server import schedule_to_wire
    from dragonfly2_tpu_torch.scheduler import ScheduleResultKind
    from dragonfly2_tpu_torch.scheduler.push import PeerStreamHub, StallMonitor
    from dragonfly2_tpu_torch.sim.swarm import host_from_latent
    from dragonfly2_tpu_torch.trainer.export import MLPScorer, scorer_to_bytes

    t_phase = time.perf_counter()
    cfg = SchedulerConfig()
    cfg.storage.dir = os.path.join(out_dir, "push_records")
    shutil.rmtree(cfg.storage.dir, ignore_errors=True)
    cfg.scheduling.algorithm = "ml"
    cfg.scheduling.eval_feature_cache_hosts = STORE_SLOTS
    cfg.scheduling.retry_interval_s = 0.0
    weights = weights_from_seed(seed)
    service = build(cfg, device=dev, scorer_blob=scorer_to_bytes(MLPScorer(weights=weights)),
                    rng=random.Random(seed), seed_trigger=False)
    ev = service.scheduling.evaluator
    batcher = ev.batcher
    hub = PeerStreamHub()
    service.hub = hub
    cluster = SyntheticCluster(num_hosts=N_HOSTS, seed=seed)
    hosts = [host_from_latent(lh) for lh in cluster.hosts]

    # The stream binding's writer queue: a push encodes the schedule and
    # enqueues it, never blocking the scheduler's thread.
    events = queue.SimpleQueue()

    def subscribe(child_id):
        def push(result):
            events.put((child_id, time.perf_counter(), time.time(),
                        [p.id for p in result.parents], schedule_to_wire(result)))
        hub.register(child_id, push)

    def drain():
        out = []
        while True:
            try:
                out.append(events.get_nowait())
            except queue.Empty:
                return out

    reset_kernel_counts()
    calls0 = batcher.scorer_calls
    for h in hosts:
        service.announce_host(h)
    urls = warm_tasks(service, cluster, hosts, n_tasks=N_TASKS, hosts_per_task=PUSH_WARM)
    warm_s = time.perf_counter() - t_phase
    children = []
    base = N_TASKS * PUSH_WARM
    for t in range(N_TASKS):
        group = []
        for i in range(PUSH_CHILDREN):
            res = service.register_peer(host=hosts[base + t * PUSH_CHILDREN + i], url=urls[t],
                                        peer_id=f"push-{t}-{i}")
            check(res.schedule is not None and res.schedule.kind is ScheduleResultKind.PARENTS,
                  f"push child {t}/{i} got no parents: {res.schedule}")
            subscribe(res.peer.id)
            group.append(res.peer)
        children.append(group)
    register_s = time.perf_counter() - t_phase - warm_s
    check(not drain(), "a push before any trigger")

    seen = {"flushes": []}
    bad_ids, eject_rows, latency_ms = set(), [], []
    with keep_k1_flushes(seen):
        # Ejection: each task's warm parent with the most children (of
        # those with a piece cost on record, so that one more makes the
        # bad-node test's sample) turns bad.
        t_eject = time.perf_counter()
        for group in children:
            task = group[0].task
            counts = Counter(p.id for c in group for p in task.load_parents(c.id)
                             if p.id.startswith("warm-") and p.piece_costs())
            check(bool(counts), f"task {task.id}: no warm parent with piece costs")
            bad_id = min(counts, key=lambda k: (-counts[k], k))
            bad = service.resource.peer_manager.load(bad_id)
            kids = sorted(c.id for c in group
                          if bad_id in {p.id for p in task.load_parents(c.id)})
            reporter = service.resource.peer_manager.load(kids[0])
            cost = int(100 * max(bad.piece_costs() or [10**6]) + 10**9)
            t0 = time.perf_counter()
            service.report_piece_finished(reporter, 0, parent_id=bad_id, length=PIECE_SIZE,
                                          cost_ns=cost)
            got = drain()
            bad_ids.add(bad_id)
            check(ev.is_bad_node(bad), f"ejected parent {bad_id} is not bad")
            pushed = sorted(cid for cid, *_ in got)
            check(pushed == kids, f"task {task.id}: pushes to {pushed}, children {kids}")
            check(all(tp - t0 < hub.push_cooldown_s for _, tp, *_ in got),
                  "an ejection push outside the report's cooldown")
            check(all(parents and not bad_ids & set(parents) for _, _, _, parents, _ in got),
                  f"an ejection push names a bad parent: {got}")
            check(all(bad_id not in {p.id for p in task.load_parents(k)} for k in kids),
                  f"a child kept its edge to the ejected parent {bad_id}")
            latency_ms += [(tp - t0) * 1e3 for _, tp, *_ in got]
            eject_rows.append(len(got))
        eject_s = time.perf_counter() - t_eject

        # The stall sweep over the idle children, its times cut.
        returns = []
        sweep = service.reschedule_stalled

        def counted(max_idle_s):
            n = sweep(max_idle_s)
            returns.append(n)
            return n

        service.reschedule_stalled = counted
        idle_until = max(c.updated_at for g in children for c in g) + PUSH_STALL_IDLE_S
        time.sleep(max(0.0, idle_until - time.time()))
        monitor = StallMonitor(service, max_idle_s=PUSH_STALL_IDLE_S,
                               interval_s=PUSH_STALL_SWEEP_S)
        t_stall = time.perf_counter()
        monitor.start()
        time.sleep(PUSH_STALL_RUN_S)
        monitor.stop()
        monitor._thread.join(60.0)
        check(not monitor._thread.is_alive(), "the stall monitor did not stop")
        stall_s = time.perf_counter() - t_stall
        del service.reschedule_stalled
    torch.cuda.synchronize()
    launches = kernel_counts()
    scorer_calls = batcher.scorer_calls - calls0
    stall = drain()
    last_push = {}
    for cid, _, wall, _, _ in stall:
        last_push[cid] = max(wall, last_push.get(cid, 0.0))
    peers = {c.id: c for g in children for c in g}
    check(len(stall) == sum(returns) > 0,
          f"{len(stall)} stall pushes, the sweeps returned {returns}")
    check(all(peers[cid].updated_at >= wall for cid, wall in last_push.items()),
          "a stall-pushed child's idle clock did not restart")
    check(all(parents and not bad_ids & set(parents) for _, _, _, parents, _ in stall),
          "a stall push names a bad parent")
    check(launches["fused_gather_mlp_score"] == scorer_calls > 0,
          f"K1 launches {launches['fused_gather_mlp_score']} != the batcher's scorer calls "
          f"{scorer_calls} on the push path")
    check(launches["segment_sum"] == 0 and launches["rule_weighted_sum"] == 0,
          f"another kernel launched on the push path: {launches}")
    check(len(seen["flushes"]) > 0, "no K1 flush on the push path")
    k1_err, k1_ms, k1_plain_ms, k1_bound_ms = k1_on_flushes(
        torch, dev, seen, k1_save_dir(out_dir), "push")
    check(k1_err <= K1_TOL, f"K1 off its plain version by {k1_err} (scaled) on the push "
          "path's flushes")

    # The stress: seeded flushes over store-like rows and the path's edges.
    t_stress = time.perf_counter()
    stress = k1_replay.stress(
        dev, flushes=K1_STRESS_FLUSHES, repeats=K1_STRESS_REPEATS, seed=seed,
        weights=weights, rows=k1_replay.store_like_rows(seed),
        edges=np.concatenate([f[0] for f in seen["flushes"]]),
        save_dir=k1_save_dir(out_dir))
    stress["seconds"] = time.perf_counter() - t_stress
    check(stress["max_err_scaled"] <= K1_TOL and stress["flushes_over_tol"] == 0,
          f"K1 off its plain version on the stress: {stress}")
    check(stress["k1_bits_vary"] == 0, f"K1's bits vary across back-to-back launches: {stress}")

    shutil.rmtree(cfg.storage.dir, ignore_errors=True)

    lat = sorted(latency_ms)
    pushes = sum(eject_rows) + len(stall)
    out = {
        "seconds": time.perf_counter() - t_phase, "warm_seconds": warm_s,
        "register_seconds": register_s, "ejection_seconds": eject_s,
        "stall_seconds": stall_s, "children": N_TASKS * PUSH_CHILDREN,
        "pushes": {"ejection": sum(eject_rows), "stall": len(stall), "total": pushes},
        "pushes_per_s": pushes / (eject_s + stall_s),
        "ejection_pushes_per_task": {"min": min(eject_rows), "max": max(eject_rows)},
        "stall_sweeps": returns,
        "report_to_callback_ms": {"p50": lat[len(lat) // 2],
                                  "p99": lat[min(len(lat) - 1, int(0.99 * len(lat)))]},
        "kernel_launches": launches,
        "k1": {"launches": launches["fused_gather_mlp_score"], "scorer_calls": scorer_calls,
               "max_err_scaled": k1_err, "tol_scaled": K1_TOL,
               "flushes_checked": len(seen["flushes"]),
               "flush_rows_checked": int(sum(len(f[1]) for f in seen["flushes"])),
               "ms_128": k1_ms, "us_128": k1_ms * 1e3, "plain_ms_128": k1_plain_ms,
               "bound_ms_128": k1_bound_ms},
        "k1_stress": stress,
        "cuts": {"warm_per_task": [HOSTS_PER_TASK, PUSH_WARM],
                 "stall_max_idle_s": [10.0, PUSH_STALL_IDLE_S],
                 "stall_sweep_interval_s": [2.0, PUSH_STALL_SWEEP_S]},
    }
    emit({"phase": "push", **out})
    return out, launches


def qos_drill_phase(torch, dev, seed, out_dir):
    """Phase 24: the tenant QoS overload drill with K1 ranking tenant A's
    parents, then the telemetry drills on the host.  Returns (summary,
    launches)."""
    from dragonfly2_tpu_torch.bench.bench_qos import MLEvaluators
    from dragonfly2_tpu_torch.sim import qos, telemetry
    from dragonfly2_tpu_torch.trainer.export import MLPScorer, scorer_to_bytes
    from dragonfly2_tpu_torch.utils import dftrace

    t_phase = time.perf_counter()
    cfg = qos.QoSDrillConfig()
    evaluators = MLEvaluators(scorer_to_bytes(MLPScorer(weights=weights_from_seed(seed))), dev)
    witness = dftrace.install()
    seen = {"flushes": []}
    try:
        reset_kernel_counts()
        with keep_k1_flushes(seen):
            drill = qos.run_isolation_drill(cfg, evaluator=evaluators,
                                            extra_parents=QD_EXTRA_PARENTS)
        torch.cuda.synchronize()
        launches = kernel_counts()
        scorer_calls = evaluators.scorer_calls()
        shapes = [sorted(dftrace.shapes_of(ev._scorer)) for ev in evaluators.built]
        over_budget = witness.over_budget()
        witnessed = witness.snapshot()
    finally:
        dftrace.uninstall()
    drill_s = time.perf_counter() - t_phase
    reset_kernel_counts()
    rule_shaped = qos._run_arm(cfg, shaped=True, burst=True, extra_parents=QD_EXTRA_PARENTS)
    rule_launches = kernel_counts()
    rule_s = time.perf_counter() - t_phase - drill_s

    shaped, unshaped = drill["shaped"], drill["unshaped"]
    acct = shaped["tenant_accounting"]
    budget = max(site["budget"] for site in dftrace.SHAPE_SITES.values())
    check(shaped["a_downloads_ok"] == cfg.a_downloads,
          f"tenant A's downloads under the shaped burst: {shaped['a_downloads_ok']}"
          f"/{cfg.a_downloads}")
    check(unshaped["b_offered"] > 100, f"the unshaped flood offered {unshaped['b_offered']}")
    check(shaped["b_sheds"] + shaped["b_throttled"] > 0, "the shaped arm never shed or capped B")
    check(shaped["seed_tenant_bytes"].get("t-b", 0) < unshaped["seed_tenant_bytes"].get("t-b", 0),
          f"B's seed bytes shaped {shaped['seed_tenant_bytes']} not below unshaped "
          f"{unshaped['seed_tenant_bytes']}")
    check(acct.get("t-a", {}).get("tenant_class") == "gold"
          and acct.get("t-b", {}).get("tenant_class") == "background",
          f"the accounting's classes: {acct}")
    check(rule_shaped["a_downloads_ok"] == cfg.a_downloads,
          f"the rule arm's A downloads: {rule_shaped['a_downloads_ok']}/{cfg.a_downloads}")
    check(launches["fused_gather_mlp_score"] == scorer_calls > 0,
          f"K1 launches {launches['fused_gather_mlp_score']} != the batchers' scorer calls "
          f"{scorer_calls} in the QoS drill")
    check(launches["segment_sum"] == 0 and launches["rule_weighted_sum"] == 0,
          f"another kernel launched in the QoS drill: {launches}")
    check(not any(rule_launches.values()), f"the rule arm launched a kernel: {rule_launches}")
    check(not over_budget and all(0 < len(x) <= budget for x in shapes),
          f"padded sizes past the budget of {budget}: {shapes} {over_budget}")
    check(len(seen["flushes"]) > 0, "no K1 flush in the QoS drill")
    k1_err, k1_ms, k1_plain_ms, k1_bound_ms = k1_on_flushes(
        torch, dev, seen, k1_save_dir(out_dir), "qos_drill")
    check(k1_err <= K1_TOL, f"K1 off its plain version by {k1_err} (scaled) on the QoS "
          "drill's flushes")

    # (b) the telemetry drills, host only.
    t_tele = time.perf_counter()
    workdir = os.path.join(out_dir, "telemetry_drills")
    shutil.rmtree(workdir, ignore_errors=True)
    reset_kernel_counts()
    kill = telemetry.run_kill_drill(os.path.join(workdir, "kill"))
    burn = telemetry.run_burnrate_drill(os.path.join(workdir, "burn.dfmj"))
    tele_launches = kernel_counts()
    check(kill["ok"] and burn["ok"], f"a telemetry drill failed: {kill} {burn}")
    check(not any(tele_launches.values()), f"a kernel launched in the telemetry drills: "
          f"{tele_launches}")
    shutil.rmtree(workdir, ignore_errors=True)

    keys = ("a_announce_p50_ms", "a_announce_p99_ms", "a_announces", "a_sheds",
            "a_downloads_ok", "a_ttlb_ms", "a_ttlb_p90_ms", "b_offered", "b_announces",
            "b_sheds", "b_pulls", "b_throttled", "seed_tenant_bytes", "seed_throttled")
    out = {
        "seconds": time.perf_counter() - t_phase, "drill_seconds": drill_s,
        "rule_arm_seconds": rule_s, "telemetry_seconds": time.perf_counter() - t_tele,
        "config": drill["config"], "extra_parents": QD_EXTRA_PARENTS,
        "arms": {arm: {k: drill[arm][k] for k in keys}
                 for arm in ("baseline", "unshaped", "shaped")},
        "rule_shaped": {k: rule_shaped[k] for k in keys},
        "movement": drill["movement"],
        "tenant_accounting": acct,
        "kernel_launches": launches,
        "shape_witness": {"scorer_shapes": shapes, "sites": witnessed, "budget": budget},
        "k1": {"launches": launches["fused_gather_mlp_score"], "scorer_calls": scorer_calls,
               "max_err_scaled": k1_err, "tol_scaled": K1_TOL,
               "flushes_checked": len(seen["flushes"]),
               "flush_rows_checked": int(sum(len(f[1]) for f in seen["flushes"])),
               "ms_128": k1_ms, "us_128": k1_ms * 1e3, "plain_ms_128": k1_plain_ms,
               "bound_ms_128": k1_bound_ms},
        "telemetry": {
            "kill": {k: kill[k] for k in ("children", "victim_sigkilled", "frames_admitted",
                                          "corrupt_rejected", "oracle_samples",
                                          "per_run_covered", "alpha", "quantile_checks")},
            "burn": {k: burn[k] for k in ("fired_after_s", "fired_within_fast_window",
                                          "cleared_after_s", "replay_burn_drift",
                                          "journal_frames", "final_state")},
            "kernel_launches": tele_launches},
    }
    emit({"phase": "qos_drill", **out})
    return out, launches


def _model_dtypes(dtype):
    """Set every model config's default compute dtype; → the old defaults."""
    import torch

    from dragonfly2_tpu_torch.models import gnn, hop, mlp

    saved = []
    for cls in (mlp.MLPConfig, gnn.GNNConfig, hop.HopConfig):
        d = cls.__init__.__defaults__
        saved.append((cls, d))
        cls.__init__.__defaults__ = tuple(dtype if isinstance(v, torch.dtype) else v for v in d)
    return saved


@contextlib.contextmanager
def f32_models():
    """Every model config of the trainer service computes in float32."""
    import torch

    saved = _model_dtypes(torch.float32)
    try:
        yield
    finally:
        for cls, d in saved:
            cls.__init__.__defaults__ = d


def _keep_leaves(keep):
    """``TrainerService._keep``, and each trained leaf as float32 numpy on
    ``run.leaves``, so that a difference between ranks has a size."""
    def wrapped(self, run, name, state, history):
        from dragonfly2_tpu_torch.trainer.train import full_params

        keep(self, run, name, state, history)
        run.__dict__.setdefault("leaves", {})[name] = {
            k: v.detach().float().cpu().numpy() for k, v in full_params(state).items()}
    return wrapped


def _summary_leaves(summary):
    """``TrainerService.summary`` with the leaves ``_keep_leaves`` kept."""
    def wrapped(self, run, registry_calls):
        return {**summary(self, run, registry_calls), "leaves": run.__dict__.get("leaves", {})}
    return wrapped


@contextlib.contextmanager
def leaves_kept():
    """Every ``TrainerService`` in this process keeps its trained leaves
    inside the block and ships them in its summary (phase 25's witness)."""
    from dragonfly2_tpu_torch.trainer.service import TrainerService

    with tapped(TrainerService, "_keep", _keep_leaves), \
            tapped(TrainerService, "summary", _summary_leaves):
        yield


def rank_leaves(rank):
    """A spawned rank's ``rank_init`` for phase 25: keep the leaves."""
    from dragonfly2_tpu_torch.trainer.service import TrainerService

    TrainerService._keep = _keep_leaves(TrainerService._keep)
    TrainerService.summary = _summary_leaves(TrainerService.summary)


def rank_f32(rank):
    """A spawned rank's ``rank_init`` for phase 25's float32 witness."""
    import torch

    _model_dtypes(torch.float32)


def rank_f32_leaves(rank):
    rank_f32(rank)
    rank_leaves(rank)


def rank_leaf_diff(ranks):
    """The first leaf (model, leaf, in name order) whose digest on some rank
    differs from rank 0's, with that rank and the max abs difference of
    the leaves (``None`` where a rank shipped no leaves); ``None`` when
    every rank's ``leaf_digests`` equal rank 0's."""
    ref = ranks[0]
    for r in ranks[1:]:
        for model in sorted(set(ref["leaf_digests"]) | set(r["leaf_digests"])):
            mine, theirs = ref["leaf_digests"].get(model, {}), r["leaf_digests"].get(model, {})
            for leaf in sorted(set(mine) | set(theirs)):
                if mine.get(leaf) == theirs.get(leaf):
                    continue
                a = ref.get("leaves", {}).get(model, {}).get(leaf)
                b = r.get("leaves", {}).get(model, {}).get(leaf)
                diff = (float(np.max(np.abs(a - b))) if a is not None and b is not None
                        and a.shape == b.shape else None)
                return {"rank": r["rank"], "model": model, "leaf": leaf, "max_abs_diff": diff}
    return None


def trainer_ranks_phase(torch, dev, seed, out_dir):
    """Phase 25: the trainer service across ranks on phase 11's shards.
    ``TrainerService(gnn_model="gat")`` trains once on ``TR_RANKS`` gloo
    ranks sharing the card (``parallel/launch.RankGroup``, this process
    rank 0), then once with no mesh on the card, both under phase 11's
    round config cut to ``TR_EPOCHS`` epochs; then ``cli.trainer.run
    (["--train-once", DIR])`` at its defaults.  Then the float32 witness:
    the same two rounds with every model config in float32 (in every
    rank), and a second float32 one-device round, the control: one
    device against itself.  Returns (summary, K3 launches on every rank
    and in the one-device run, K3's error)."""
    import torch.distributed as dist

    from dragonfly2_tpu_torch.cli import trainer as trainer_cli
    from dragonfly2_tpu_torch.config import TrainerConfigFile, load_config
    from dragonfly2_tpu_torch.manager.registry import ModelRegistry
    from dragonfly2_tpu_torch.ops import segment
    from dragonfly2_tpu_torch.ops.segment import _segment_sum_plain
    from dragonfly2_tpu_torch.parallel.launch import RankGroup, plan_ranks
    from dragonfly2_tpu_torch.records.columnar import concat_readers
    from dragonfly2_tpu_torch.trainer.service import (
        GNN_MODEL_NAME, MLP_MODEL_NAME, TrainerService,
    )
    from dragonfly2_tpu_torch.trainer.train import split_edges

    t_phase = time.perf_counter()
    # Phase 11's shards (written there from the same seed).
    shard_dir = os.path.join(out_dir, "trainer_shards")
    if not os.path.exists(os.path.join(shard_dir, "download_0.dfc")):
        write_service_shards(shard_dir, seed)
    base = trainer_cli.train_config(load_config(TrainerConfigFile, env=False))
    cfg = dataclasses.replace(base, epochs=TR_EPOCHS, log_every=1)

    def train(service):
        session = service.open_train_stream(ip="127.0.0.1", hostname="chip-smoke",
                                            scheduler_id="s")
        session.send_download_shard(os.path.join(shard_dir, "download_0.dfc"))
        session.send_network_topology_shard(os.path.join(shard_dir, "networktopology_0.dfc"))
        run = service.runs[session.close_and_train()]
        torch.cuda.synchronize()
        return run

    # Rank 0's first K3 input, in this process (the gather's backward).
    seen = {}

    def keep_first_k3(fn):
        def wrapped(values, plan, **kw):
            seen.setdefault("k3", (values.detach().clone(), plan, kw))
            return fn(values, plan, **kw)
        return wrapped

    def train_ranked(registry, rank_init=None):
        group = RankGroup(TR_RANKS, device="cuda",
                          store_dir=os.path.join(out_dir, "trainer_ranks"), rank_init=rank_init)
        t0 = time.perf_counter()
        try:
            run = train(TrainerService(registry, gnn_model="gat", train_config=cfg,
                                       ranks=group))
            seconds = time.perf_counter() - t0
            helpers = group.helper_pids
        finally:
            group.close()
        check(run.error is None, f"the {TR_RANKS}-rank round failed: {run.error}")
        check(not dist.is_initialized() and not any(_pid_alive(p) for p in helpers),
              "the rank group outlived its close")
        return run, seconds, group.plan

    registry = ModelRegistry()
    reset_kernel_counts()
    with tapped(segment, "segment_sum_bucketed", keep_first_k3), leaves_kept():
        ranked, round_s, plan = train_ranked(registry, rank_init=rank_leaves)
    rank0_launches = kernel_counts()

    reset_kernel_counts()
    t1 = time.perf_counter()
    one = train(TrainerService(ModelRegistry(), gnn_model="gat", train_config=cfg, device=dev))
    one_s = time.perf_counter() - t1
    one_launches = kernel_counts()
    check(one.error is None, f"the one-device round failed: {one.error}")

    # The binary at its defaults (but the epochs, the phase's, through the
    # environment): one rank a visible card, no group.
    out = io.StringIO()
    cli_registry = ModelRegistry()
    saved_epochs = os.environ.get("DRAGONFLY_TRAINER_TRAINING_EPOCHS")
    os.environ["DRAGONFLY_TRAINER_TRAINING_EPOCHS"] = str(TR_EPOCHS)
    try:
        with contextlib.redirect_stdout(out):
            cli_rc = trainer_cli.run(["--train-once", shard_dir], registry=cli_registry)
    finally:
        if saved_epochs is None:
            os.environ.pop("DRAGONFLY_TRAINER_TRAINING_EPOCHS", None)
        else:
            os.environ["DRAGONFLY_TRAINER_TRAINING_EPOCHS"] = saved_epochs
    cli_lines = out.getvalue().splitlines()
    for line in cli_lines:
        print(line, flush=True)
    cli_world = plan_ranks("cuda").world

    # The float32 witness (after the counts were read): the same two rounds
    # with every model config in float32, and the control.
    t2 = time.perf_counter()
    with f32_models():
        with leaves_kept():
            ranked32, round32_s, _ = train_ranked(ModelRegistry(), rank_init=rank_f32_leaves)
        one32, control = (train(TrainerService(ModelRegistry(), gnn_model="gat",
                                               train_config=cfg, device=dev))
                          for _ in range(2))
    witness_s = time.perf_counter() - t2
    check(one32.error is None and control.error is None,
          f"a float32 one-device round failed: {one32.error}, {control.error}")

    # K3 against its plain version on rank 0's first backward input (these
    # launches come after the counts were read).
    values, k3_plan, k3_kw = seen["k3"]
    got = segment.segment_sum_bucketed(values, k3_plan, **k3_kw)
    torch.cuda.synchronize()
    want = _segment_sum_plain(values, k3_plan, exact=k3_kw["exact"],
                              presorted=k3_kw.get("presorted", False))
    k3_err = float((got - want).abs().max())
    k3_max = float(want.abs().max())

    dl = concat_readers([os.path.join(shard_dir, "download_0.dfc")])
    target = dl[:, -1].astype(np.float32)
    val_idx, train_idx = split_edges(len(target), cfg.seed)
    mean_mae = mean_predictor_mae(target, val_idx, train_idx)
    steps = ranked.history[GNN_MODEL_NAME][-1]["step"] if ranked.history.get(GNN_MODEL_NAME) \
        else 0
    layers = 1  # the service's GAT: GNNConfig(num_layers=1)
    rank_k3 = [rank0_launches["segment_sum"]] + [r["segment_sum_launches"]
                                                 for r in ranked.ranks[1:]]
    # Relative loss error at every logged step.  The GAT computes in bf16:
    # on the H100 its 2-rank losses leave the one-device losses by 5e-4 to
    # 1.4e-3 in the first epoch.  Past its loss spike (~step 43) the GAT's
    # trajectory amplifies any last-bit difference ~1e5-fold: in float32,
    # one device against itself (the control: the batch gathers' backward
    # adds with atomics) departs by up to 0.26 at a step, as the 2 ranks
    # do.  So the GATs are held over their first epoch (bf16 at the mesh
    # trainers' tests' bound, float32 at 1e-4), by their MAE, and by equal
    # parameters on every rank; the MLPs at every step.
    def rel_curve(got, want, name):
        a = np.array([h["loss"] for h in got.history.get(name, [])])
        b = np.array([h["loss"] for h in want.history.get(name, [])])
        return np.abs(a - b) / np.abs(b) if len(a) == len(b) > 0 else np.array([np.inf])

    loss_curve = {name: rel_curve(ranked, one, name) for name in (MLP_MODEL_NAME, GNN_MODEL_NAME)}
    f32_curve = {name: rel_curve(ranked32, one32, name)
                 for name in (MLP_MODEL_NAME, GNN_MODEL_NAME)}
    control_curve = {name: rel_curve(control, one32, name)
                     for name in (MLP_MODEL_NAME, GNN_MODEL_NAME)}

    def onset(curve):
        over = np.nonzero(curve > TR_ONSET)[0]
        return int(over[0]) + 1 if len(over) else None

    gat_epoch = max(steps // cfg.epochs, 1)
    f32_err = {MLP_MODEL_NAME: float(f32_curve[MLP_MODEL_NAME].max()),
               GNN_MODEL_NAME + "/first_epoch":
               float(f32_curve[GNN_MODEL_NAME][:gat_epoch].max())}
    loss_err = {MLP_MODEL_NAME: float(loss_curve[MLP_MODEL_NAME].max()),
                GNN_MODEL_NAME + "/first_epoch": float(loss_curve[GNN_MODEL_NAME][:gat_epoch].max())}
    gnn_curve = loss_curve[GNN_MODEL_NAME]
    over = np.nonzero(gnn_curve > TR_GAT_LOSS_RTOL)[0]
    gnn_mae = (ranked.metrics[GNN_MODEL_NAME].mae, one.metrics[GNN_MODEL_NAME].mae)
    models = sorted((m.name, m.type, m.version) for m in registry.list())
    phase_s = time.perf_counter() - t_phase - witness_s
    summary = {
        "ranks": TR_RANKS, "backend": plan.backend, "devices": list(plan.devices),
        "epochs": cfg.epochs, "gat_steps": steps, "gat_layers": layers,
        "round_seconds": round_s, "one_device_seconds": one_s, "phase_seconds": phase_s,
        "step_ms_p50": {"world2": step_p50_of(ranked.history[GNN_MODEL_NAME]),
                        "world1": step_p50_of(one.history[GNN_MODEL_NAME])},
        "mlp_step_ms_p50": {"world2": step_p50_of(ranked.history[MLP_MODEL_NAME]),
                            "world1": step_p50_of(one.history[MLP_MODEL_NAME])},
        "registered": models, "registry_calls": [r["registry_calls"] for r in ranked.ranks],
        "metrics": {"world2": {k: m.to_dict() for k, m in ranked.metrics.items()},
                    "world1": {k: m.to_dict() for k, m in one.metrics.items()}},
        "rank_models": [sorted(r["leaf_digests"]) for r in ranked.ranks],
        "rank_leaf_diff": rank_leaf_diff(ranked.ranks),
        "mean_predictor_mae": mean_mae, "loss_rel_err": loss_err,
        "gat_loss_rel_err": {"max": float(gnn_curve.max()),
                             "first_step_over_tol": int(over[0]) + 1 if len(over) else None,
                             "last_step": float(gnn_curve[-1]),
                             "steps_per_epoch": gat_epoch},
        "gat_mae_rel_diff": abs(gnn_mae[0] - gnn_mae[1]) / gnn_mae[1],
        "f32_witness": {
            "loss_rel_err": f32_err,
            "gat_max": float(f32_curve[GNN_MODEL_NAME].max()),
            "gat_onset_step": onset(f32_curve[GNN_MODEL_NAME]),
            "gat_last_step": float(f32_curve[GNN_MODEL_NAME][-1]),
            "control": {"mlp_max": float(control_curve[MLP_MODEL_NAME].max()),
                        "gat_first_epoch": float(control_curve[GNN_MODEL_NAME][:gat_epoch].max()),
                        "gat_max": float(control_curve[GNN_MODEL_NAME].max()),
                        "gat_onset_step": onset(control_curve[GNN_MODEL_NAME])},
            "gat_curves": {"bf16": [float(v) for v in gnn_curve],
                           "f32": [float(v) for v in f32_curve[GNN_MODEL_NAME]],
                           "control": [float(v) for v in control_curve[GNN_MODEL_NAME]]},
            "rank_models": [sorted(r["leaf_digests"]) for r in ranked32.ranks],
            "rank_leaf_diff": rank_leaf_diff(ranked32.ranks),
            "leaves": {m: len(v) for m, v in ranked32.ranks[0]["leaf_digests"].items()},
            "gat_steps": len(ranked32.history.get(GNN_MODEL_NAME, [])),
            "round_seconds": round32_s, "seconds": witness_s,
            "mae": {"world2": {k: m.mae for k, m in ranked32.metrics.items()},
                    "world1": {k: m.mae for k, m in one32.metrics.items()}},
        },
        "k3_launches": {"ranks": rank_k3, "one_device": one_launches["segment_sum"]},
        "k3": {"rows": int(values.shape[0]), "d": int(values.shape[1]),
               "max_abs_err": k3_err, "max_abs_want": k3_max, "tol_relative": K3_TOL},
        "cli": {"rc": cli_rc, "world": cli_world, "lines": cli_lines,
                "models": sorted(m.name for m in cli_registry.list())},
    }
    emit({"phase": "trainer_ranks", **summary})
    check(models == sorted([(GNN_MODEL_NAME, "gnn", 1), (MLP_MODEL_NAME, "mlp", 1)]),
          f"the {TR_RANKS}-rank round registered {models}")
    check(summary["registry_calls"] == [2] + [0] * (TR_RANKS - 1),
          f"registry calls by rank {summary['registry_calls']}")
    both = sorted([GNN_MODEL_NAME, MLP_MODEL_NAME])
    check(summary["rank_models"] == [both] * TR_RANKS and summary["rank_leaf_diff"] is None,
          f"the ranks' trained parameters differ, first at {summary['rank_leaf_diff']} "
          f"(models by rank {summary['rank_models']})")
    check(summary["f32_witness"]["rank_models"] == [both] * TR_RANKS
          and summary["f32_witness"]["rank_leaf_diff"] is None,
          "the float32 witness's ranks hold different parameters, first at "
          f"{summary['f32_witness']['rank_leaf_diff']}")
    check(summary["f32_witness"]["gat_steps"] == len(ranked.history[GNN_MODEL_NAME])
          and max(f32_err.values()) <= TR_F32_LOSS_RTOL,
          f"float32 {TR_RANKS}-rank losses off the one-device losses: {f32_err}")
    check(loss_err[MLP_MODEL_NAME] <= TR_LOSS_RTOL
          and loss_err[GNN_MODEL_NAME + "/first_epoch"] <= TR_GAT_LOSS_RTOL,
          f"{TR_RANKS}-rank losses off the one-device losses: {loss_err}")
    check(summary["gat_mae_rel_diff"] <= TR_MAE_BAND,
          f"the GATs' validation MAE {gnn_mae} differ by more than {TR_MAE_BAND:.0%}")
    check(steps > 0 and all(n == steps * layers for n in rank_k3)
          and one_launches["segment_sum"] == steps * layers,
          f"K3 launches {rank_k3} (one device {one_launches['segment_sum']}) != "
          f"{steps} steps x {layers} layers on each rank")
    check(bool(torch.isfinite(got).all()) and k3_err <= K3_TOL * k3_max,
          f"K3 off its plain version by {k3_err} on rank 0's input (max |sum| {k3_max})")
    check(ranked.metrics[GNN_MODEL_NAME].mae < mean_mae and one.metrics[GNN_MODEL_NAME].mae
          < mean_mae, f"a GAT's MAE is not below the mean predictor's {mean_mae}: "
          f"{ranked.metrics[GNN_MODEL_NAME].mae}, {one.metrics[GNN_MODEL_NAME].mae}")
    check(cli_rc == 0 and cli_world == 1 and sorted(summary["cli"]["models"])
          == sorted([MLP_MODEL_NAME, GNN_MODEL_NAME])
          and not any(x.startswith("trainer: training on") for x in cli_lines)
          and not dist.is_initialized(),
          f"the binary at its defaults: rc {cli_rc}, world {cli_world}, {cli_lines}")
    check(phase_s <= TR_SECONDS, f"phase 25 took {phase_s:.1f} s (limit {TR_SECONDS})")
    check(witness_s <= TR_WITNESS_SECONDS,
          f"phase 25's float32 witness took {witness_s:.1f} s (limit {TR_WITNESS_SECONDS})")
    shutil.rmtree(shard_dir, ignore_errors=True)
    return summary, rank_k3 + [one_launches["segment_sum"]], k3_err


def _pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


def registry_proxy_phase(torch, dev, seed, out_dir):
    """Phase 26: a node pool pulling one image through the daemons'
    registry proxies and reading objects through their gateways
    (``bench/registry_proxy``), K1 ranking the parents.  Returns
    (summary, launches)."""
    from dragonfly2_tpu_torch.bench import registry_proxy

    seen = {"flushes": []}
    args = registry_proxy.parse_args([
        "--daemons", str(RP_DAEMONS), "--layers-mib", RP_LAYERS_MIB,
        "--objects", str(RP_OBJECTS), "--object-mib", str(RP_OBJECT_MIB),
        "--seed", str(seed), "--out", out_dir, "--device", "cuda",
    ])
    reset_kernel_counts()
    t0 = time.perf_counter()
    with keep_k1_flushes(seen):
        summary = registry_proxy.run(args, log=lambda line: print(line, flush=True))
    torch.cuda.synchronize()
    launches = kernel_counts()
    phase_s = time.perf_counter() - t0
    check(len(seen["flushes"]) > 0, "no K1 flush on the registry proxy's path")
    k1_err, k1_ms, k1_plain_ms, k1_bound_ms = k1_on_flushes(
        torch, dev, seen, k1_save_dir(out_dir), "registry_proxy")
    out = {
        **summary, "phase_seconds": phase_s, "kernel_launches": launches,
        "k1": {"launches": launches["fused_gather_mlp_score"],
               "scorer_calls": summary["scorer_calls"], "max_err_scaled": k1_err,
               "tol_scaled": K1_TOL, "flushes_checked": len(seen["flushes"]),
               "ms_128": k1_ms, "us_128": k1_ms * 1e3, "plain_ms_128": k1_plain_ms,
               "bound_ms_128": k1_bound_ms},
    }
    emit({"phase": "registry_proxy", **out})
    for name, ok in summary["checks"].items():
        check(ok, f"registry proxy check {name} failed: {json.dumps(summary)}")
    check(launches["fused_gather_mlp_score"] == summary["scorer_calls"] > 0,
          f"K1 launches {launches['fused_gather_mlp_score']} != the batcher's scorer calls "
          f"{summary['scorer_calls']} on the registry proxy")
    check(launches["segment_sum"] == 0 and launches["rule_weighted_sum"] == 0,
          f"another kernel launched on the registry proxy: {launches}")
    check(k1_err <= K1_TOL, f"K1 off its plain version by {k1_err} (scaled) on the "
          "registry proxy's flushes")
    check(phase_s <= RP_SECONDS, f"phase 26 took {phase_s:.1f} s (limit {RP_SECONDS})")
    return out, launches


def secure_cluster_phase(torch, dev, seed, out_dir):
    """Phase 27: the secured cluster (``bench/secure_cluster``): the
    manager's CA, users and PATs, auto-issued mTLS on the piece plane and
    the scheduler's gRPC port, the SNI proxy, K1 ranking the parents.
    Returns (summary, launches)."""
    from dragonfly2_tpu_torch.bench import secure_cluster

    seen = {"flushes": []}
    args = secure_cluster.parse_args([
        "--daemons", str(SC_DAEMONS), "--file-mib", str(SC_FILE_MIB),
        "--layers-mib", SC_LAYERS_MIB, "--seed", str(seed), "--out", out_dir,
        "--device", "cuda",
    ])
    reset_kernel_counts()
    t0 = time.perf_counter()
    with keep_k1_flushes(seen):
        summary = secure_cluster.run(args, log=lambda line: print(line, flush=True))
    torch.cuda.synchronize()
    launches = kernel_counts()
    phase_s = time.perf_counter() - t0
    check(len(seen["flushes"]) > 0, "no K1 flush on the secured cluster's path")
    k1_err, k1_ms, k1_plain_ms, k1_bound_ms = k1_on_flushes(
        torch, dev, seen, k1_save_dir(out_dir), "secure_cluster")
    out = {
        **summary, "phase_seconds": phase_s, "kernel_launches": launches,
        "k1": {"launches": launches["fused_gather_mlp_score"],
               "scorer_calls": summary["scorer_calls"], "max_err_scaled": k1_err,
               "tol_scaled": K1_TOL, "flushes_checked": len(seen["flushes"]),
               "ms_128": k1_ms, "us_128": k1_ms * 1e3, "plain_ms_128": k1_plain_ms,
               "bound_ms_128": k1_bound_ms},
    }
    emit({"phase": "secure_cluster", **out})
    for name, ok in summary["checks"].items():
        check(ok, f"secure cluster check {name} failed: {json.dumps(summary)}")
    check(launches["fused_gather_mlp_score"] == summary["scorer_calls"] > 0,
          f"K1 launches {launches['fused_gather_mlp_score']} != the batcher's scorer calls "
          f"{summary['scorer_calls']} on the secured cluster")
    check(launches["segment_sum"] == 0 and launches["rule_weighted_sum"] == 0,
          f"another kernel launched on the secured cluster: {launches}")
    check(k1_err <= K1_TOL, f"K1 off its plain version by {k1_err} (scaled) on the "
          "secured cluster's flushes")
    check(phase_s <= SC_SECONDS, f"phase 27 took {phase_s:.1f} s (limit {SC_SECONDS})")
    return out, launches


def manager_failover_phase(torch, dev, seed, out_dir):
    """Phase 28: manager HA (``bench/manager_failover``): two manager
    binaries, the leader SIGKILLed with a preheat queued, the standby
    promoted on its lease's expiry, K1 ranking the parents of three waves
    of downloads throughout, model B activated at the survivor.  Every
    flush is kept and held to K1's plain version on its own mirror.
    Returns (summary, launches)."""
    from dragonfly2_tpu_torch.bench import manager_failover
    from dragonfly2_tpu_torch.bench.wire_loop import seeded_k1_blob
    from dragonfly2_tpu_torch.trainer.export import load_scorer

    seen = {"flushes": []}
    args = manager_failover.parse_args([
        "--daemons", str(MF_DAEMONS), "--file-mib", str(MF_FILE_MIB),
        "--seed", str(seed), "--out", out_dir, "--device", "cuda",
    ])
    reset_kernel_counts()
    t0 = time.perf_counter()
    with keep_k1_flushes(seen, cap=1 << 30):
        summary = manager_failover.run(args, log=lambda line: print(line, flush=True))
    torch.cuda.synchronize()
    launches = kernel_counts()
    phase_s = time.perf_counter() - t0
    check(len(seen["flushes"]) > 0, "no K1 flush on the manager failover's path")
    k1_err, k1_ms, k1_plain_ms, k1_bound_ms = k1_on_flushes(
        torch, dev, seen, k1_save_dir(out_dir), "manager_failover")
    # Which model's weights each kept flush scored with, in flush order.
    weights = {k: load_scorer(seeded_k1_blob(seed + i)).weights for i, k in enumerate("AB")}

    def model_of(scorer):
        w = scorer._ref.weights
        return next((k for k, ref in weights.items() if all(
            np.array_equal(a, b) and np.array_equal(c, d) for (a, c), (b, d) in zip(ref, w))),
            "other")

    order = [model_of(sc) for sc in seen["scorers"]]
    by_model = {k: order.count(k) for k in ("A", "B", "other")}
    out = {
        **summary, "phase_seconds": phase_s, "kernel_launches": launches,
        "k1": {"launches": launches["fused_gather_mlp_score"],
               "scorer_calls": summary["scorer_calls"], "max_err_scaled": k1_err,
               "tol_scaled": K1_TOL, "flushes_checked": len(seen["flushes"]),
               "flushes_by_model": by_model,
               "ms_128": k1_ms, "us_128": k1_ms * 1e3, "plain_ms_128": k1_plain_ms,
               "bound_ms_128": k1_bound_ms},
    }
    emit({"phase": "manager_failover", **out})
    for name, ok in summary["checks"].items():
        check(ok, f"manager failover check {name} failed: {json.dumps(summary)}")
    check(launches["fused_gather_mlp_score"] == summary["scorer_calls"] == len(order) > 0,
          f"K1 launches {launches['fused_gather_mlp_score']} != the batcher's scorer calls "
          f"{summary['scorer_calls']} (flushes kept {len(order)}) through the failover")
    check(launches["segment_sum"] == 0 and launches["rule_weighted_sum"] == 0,
          f"another kernel launched through the failover: {launches}")
    check(by_model["other"] == 0 and by_model["A"] == summary["scorer_calls_by_model"]["A"]
          and by_model["B"] == summary["scorer_calls_by_model"]["B"] > 0
          and order == sorted(order),
          f"the flushes' weights {by_model} are not model A's, then model B's after "
          f"its install ({summary['scorer_calls_by_model']})")
    check(k1_err <= K1_TOL, f"K1 off its plain version by {k1_err} (scaled) on the "
          "manager failover's flushes")
    check(phase_s <= MF_SECONDS, f"phase 28 took {phase_s:.1f} s (limit {MF_SECONDS})")
    return out, launches


def read_trace_log(path):
    """The flight-recorder reader (``bench/trace_assemble``) on one
    durable log: its traces, frames admitted and rejected, the anomalies
    of every assembled trace, and the ``scheduler/eval.flush`` spans in
    them."""
    from dragonfly2_tpu_torch.bench import trace_assemble

    spans, (stats,) = trace_assemble.load_logs([path])
    traces = trace_assemble.assemble(spans)
    return {"traces": len(traces), "frames": stats["frames"], "corrupt": stats["corrupt"],
            "anomalies": sum(len(trace_assemble.anomalies_of(t)) for t in traces.values()),
            "flush_spans": sum(sp["name"] == "scheduler/eval.flush"
                               for t in traces.values() for sp in t),
            "largest_trace_spans": max(map(len, traces.values()), default=0)}


DEPLOY_SERVICES = ("manager", "trainer", "scheduler", "seed", "daemon-a", "daemon-b")


def deploy_phase(out_dir):
    """Phase 29: ``python -m dragonfly2_tpu_torch.deploy.run_local`` as a
    child at its defaults, in a session of its own so that a run past the
    limit is killed with every process it started.  Its output goes to
    ``OUT/deploy/run_local.log``.  Returns (summary, launches): the
    launches are the sums of the services' own counts, each read from
    the launch line its binary prints as it stops."""
    import re

    work = os.path.join(out_dir, "deploy")
    os.makedirs(work, exist_ok=True)
    reset_kernel_counts()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dragonfly2_tpu_torch.deploy.run_local"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO}, start_new_session=True,
    )
    timed_out = False
    try:
        out, _ = proc.communicate(timeout=DEPLOY_SECONDS)
    except subprocess.TimeoutExpired:
        timed_out = True
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    try:  # anything of the cluster still alive
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    own = kernel_counts()
    with open(os.path.join(work, "run_local.log"), "w") as f:
        f.write(out)
    boots = {m[1]: float(m[2]) for m in re.finditer(
        r"^run_local: (\S+) up in ([\d.]+) s$", out, re.M)}
    stages = {}
    for m in re.finditer(r"^e2e: .* \[stage (\d+): ([\d.]+) s\]$", out, re.M):
        stages[int(m[1])] = max(stages.get(int(m[1]), 0.0), float(m[2]))
    rnd = re.search(r"^e2e: trainer run (\S+) finished on (\S+) in ([\d.]+) s", out, re.M)
    passed = re.search(r"^e2e: ALL STAGES PASSED", out, re.M) is not None
    services = {m[1]: json.loads(m[2]) for m in re.finditer(
        r"^run_local: (\S+) kernel launches (\{.*\})$", out, re.M)}
    launches = {name: sum(counts.get(name, 0) for counts in services.values())
                for name in own}
    summary = {
        "seconds": seconds, "returncode": proc.returncode, "timed_out": timed_out,
        "boot_seconds": boots, "stage_seconds": stages,
        "trainer_round": ({"run": rnd[1], "device": rnd[2], "seconds": float(rnd[3])}
                          if rnd else None),
        "all_stages_passed": passed, "service_kernel_launches": services,
        "kernel_launches": launches, "smoke_process_launches": own,
        "launch_note": "each binary counts its own launches and prints them as it stops; "
                       "the rule scheduler and an MLP-only round reach none of K1-K3",
    }
    emit({"phase": "deploy", **summary})
    tail = out[-3000:]
    check(not timed_out and proc.returncode == 0 and passed,
          f"run_local exited {proc.returncode} (timed out: {timed_out}), all stages "
          f"passed: {passed}:\n{tail}")
    check(tuple(boots) == DEPLOY_SERVICES, f"services booted {list(boots)}:\n{tail}")
    check(sorted(stages) == [1, 2, 3, 4, 5], f"stages {sorted(stages)}:\n{tail}")
    check(rnd is not None and rnd[2].split(":")[0] == "cuda",
          f"the trainer's round did not train on cuda: {summary['trainer_round']}")
    check(sorted(services) == sorted(DEPLOY_SERVICES),
          f"launch lines read from {sorted(services)}, not from every service")
    check(not any(launches.values()) and not any(own.values()),
          f"a kernel was launched: services {services}, this process {own}")
    check(seconds <= DEPLOY_SECONDS, f"phase 29 took {seconds:.1f} s (limit {DEPLOY_SECONDS})")
    return summary, launches


def repeat_trainer_ranks(torch, dev, seed, work_dir, times) -> int:
    """Phase 25 alone, ``times`` runs in one process: each run's rank
    witness (``rank_leaf_diff`` in bf16 and in float32, None when every
    rank's leaves are equal) or the check it failed.  No contract line:
    this is not the smoke."""
    held = 0
    for i in range(times):
        t0 = time.perf_counter()
        try:
            summary, _, _ = trainer_ranks_phase(torch, dev, seed, work_dir)
            run = {"ok": True, "rank_leaf_diff": summary["rank_leaf_diff"],
                   "f32_rank_leaf_diff": summary["f32_witness"]["rank_leaf_diff"]}
            held += 1
        except SmokeFailure as exc:
            run = {"ok": False, "failed": str(exc)}
        emit({"phase": "trainer_ranks_repeat", "run": i + 1, "seconds": time.perf_counter() - t0,
              **run})
    emit({"phase": "trainer_ranks_repeat", "runs": times, "held": held})
    return 0 if held == times else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="directory for the nvcc report and a JSON summary")
    ap.add_argument("--repeat-trainer-ranks", type=int, default=0, metavar="N",
                    help="after the build, run phase 25 alone N times, print each run's "
                         "rank witness, and stop (exit 0 if every run held)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from dragonfly2_tpu_torch.cli.scheduler import SchedulerConfig, build
    from dragonfly2_tpu_torch.ops import _build, segment
    from dragonfly2_tpu_torch.ops.fused_score import (
        LAUNCHES,
        RULE_COMPONENT_WEIGHTS,
        _fused_score_plain,
        _rule_sum_plain,
        fused_gather_mlp_score,
        rule_sum,
    )
    from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
    from dragonfly2_tpu_torch.sim.swarm import host_from_latent
    from dragonfly2_tpu_torch.trainer.export import MLPScorer, load_scorer, scorer_to_bytes

    # "f32" means f32 on the card: no TF32 in the plain versions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "not read"
    print(card, flush=True)
    from dragonfly2_tpu_torch import native

    gxx = shutil.which("g++")
    check(gxx is not None, "g++ not found: the native host engine cannot be built")
    gxx_version = subprocess.run([gxx, "--version"], capture_output=True, text=True,
                                 timeout=60).stdout.splitlines()[0]
    print(f"g++: {gxx_version}", flush=True)
    t0 = time.perf_counter()
    # The native engine builds with g++ while nvcc builds the kernels.
    native_build = threading.Thread(target=native.load, name="native-build")
    native_build.start()
    _build.load()
    native_build.join()
    build_s = time.perf_counter() - t0
    print(_build.build_log, file=sys.stderr, flush=True)
    emit({"phase": "build", "card": card, "seconds": build_s,
          "nvcc_seconds": _build.build_seconds, "gxx": gxx_version,
          "native_seconds": native.build_seconds, "native_library": str(native.lib_path)})
    check(native.build_error() is None,
          f"the native host engine did not build: {native.build_error()}")

    work_dir = args.out or os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work_dir, exist_ok=True)
    if args.repeat_trainer_ranks:
        return repeat_trainer_ranks(torch, dev, args.seed, work_dir, args.repeat_trainer_ranks)

    # -- 2. serving path ----------------------------------------------------
    cfg = SchedulerConfig()
    # The warm-up's finished downloads are written as Download records.
    cfg.storage.dir = os.path.join(work_dir, "serving_records")
    shutil.rmtree(cfg.storage.dir, ignore_errors=True)
    cfg.scheduling.algorithm = "ml"
    cfg.scheduling.eval_feature_cache_hosts = STORE_SLOTS
    cfg.scheduling.eval_batch_linger_ms = 1.5
    # As the reference simulator runs: a cold task's first registration
    # goes back to source without sleeping out the retry loop.
    cfg.scheduling.retry_interval_s = 0.0
    blob = scorer_to_bytes(MLPScorer(weights=weights_from_seed(args.seed)))
    # The cluster's seed hosts are synthetic (no daemon answers their
    # port): no cold-task seed trigger, as before the trigger existed.
    service = build(cfg, device=dev, scorer_blob=blob, rng=random.Random(args.seed),
                    seed_trigger=False)
    ev = service.scheduling.evaluator
    batcher = ev.batcher
    scorer = ev._scorer
    cluster = SyntheticCluster(num_hosts=N_HOSTS, seed=args.seed)
    hosts = [host_from_latent(lh) for lh in cluster.hosts]

    writers2, untap_writers = tap_record_writers()
    reset_kernel_counts()
    t_path = time.perf_counter()
    for h in hosts:
        service.announce_host(h)
    urls = warm_tasks(service, cluster, hosts, n_tasks=N_TASKS,
                      hosts_per_task=HOSTS_PER_TASK)
    warm_s = time.perf_counter() - t_path
    calls0, batches0, reqs0 = batcher.scorer_calls, batcher.batches, batcher.batched_requests
    k1_0 = LAUNCHES["fused_gather_mlp_score"]
    n_req = THREADS * PER_THREAD
    records, timing, kinds = serve_requests(
        service, hosts, urls, hosts_per_task=HOSTS_PER_TASK, threads=THREADS,
        per_thread=PER_THREAD,
    )
    concurrent = summarize(timing, n_req)
    concurrent.update({
        "threads": THREADS, "schedule_kinds": kinds,
        "requests_per_flush": (batcher.batched_requests - reqs0)
        / max(batcher.batches - batches0, 1),
        "k1_launches": LAUNCHES["fused_gather_mlp_score"] - k1_0,
    })
    # One client, the same kind of request: the uncontended breakdown.
    k1_1 = LAUNCHES["fused_gather_mlp_score"]
    seq_records, seq_timing, seq_kinds = serve_requests(
        service, hosts, urls, hosts_per_task=HOSTS_PER_TASK, threads=1,
        per_thread=SEQUENTIAL, first=n_req,
    )
    sequential = summarize(seq_timing, SEQUENTIAL)
    sequential.update({
        "threads": 1, "schedule_kinds": seq_kinds,
        "k1_launches": LAUNCHES["fused_gather_mlp_score"] - k1_1,
    })
    scored = [r for r in records if len(r[0]) >= 2]
    records = scored + [r for r in seq_records if len(r[0]) >= 2]
    comps, k2_path_err = rule_arm(ev, records, dev)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    copies = {"uploads": scorer.uploads, "downloads": scorer.downloads}
    path_s = time.perf_counter() - t_path
    emit({
        "phase": "serving", "seconds": path_s, "warm_seconds": warm_s,
        "concurrent": concurrent, "sequential": sequential,
        "scored_ge2": len(scored),
        "batcher": {"scorer_calls": batcher.scorer_calls, "batches": batcher.batches,
                    "mean_occupancy": batcher.mean_occupancy(),
                    "fallbacks": batcher.fallbacks},
        "rule_degrades": ev.degrades, "launches": launches, "scorer_copies": copies,
        "k2_path_max_abs_err": k2_path_err,
        "download_records": service.storage.download_count,
    })

    # -- 3. the path against the reference ----------------------------------
    check(launches["fused_gather_mlp_score"] > 0, "K1 never launched on the path")
    check(launches["fused_gather_mlp_score"] == batcher.scorer_calls,
          f"K1 launches {launches['fused_gather_mlp_score']} != batcher scorer "
          f"calls {batcher.scorer_calls}")
    check(copies["uploads"] == copies["downloads"] == launches["fused_gather_mlp_score"],
          f"scorer copies {copies} != one upload and one download per K1 launch")
    check(launches["rule_weighted_sum"] == len(records), "K2 launches != rule-arm calls")
    check(segment.LAUNCHES["segment_sum"] == 0, "K3 launched by the serving path")
    check(batcher.fallbacks == 0, f"{batcher.fallbacks} batcher fallbacks")
    check(ev.degrades == 0, f"{ev.degrades} announces degraded to the rule ranking")
    check(len(scored) >= 0.9 * n_req,
          f"only {len(scored)} of {n_req} requests scored >= 2 candidates")
    check(k2_path_err <= K2_TOL, f"K2 on the path off by {k2_path_err}")
    check(service.storage.download_count == N_TASKS * HOSTS_PER_TASK,
          f"{service.storage.download_count} Download records for "
          f"{N_TASKS * HOSTS_PER_TASK} finished warm-up downloads")
    service.storage.flush()
    untap_writers()
    check_native_writes(writers2, dfc_rows(service.storage.download_columnar_paths()
                                           + service.storage.network_topology_columnar_paths()),
                        "serving")
    shutil.rmtree(cfg.storage.dir, ignore_errors=True)
    ref = load_scorer(blob)
    score_err, inputs = verify_rankings(ev, scorer, ref, records)
    emit({"phase": "reference", "requests_checked": len(records),
          "max_abs_score_err": score_err, "tol": SCORE_TOL})

    # -- 4. kernels against their plain versions ----------------------------
    mat = scorer._sync_mirror()
    mlp = scorer.mlp
    edge_all = np.concatenate([e for e, _, _ in inputs])
    src_all = np.concatenate([s for _, s, _ in inputs]).astype(np.int32)
    dst_all = np.concatenate([d for _, _, d in inputs]).astype(np.int32)

    def k1_inputs(n):
        idx = np.arange(n) % edge_all.shape[0]
        return (
            torch.from_numpy(np.ascontiguousarray(src_all[idx])).to(dev),
            torch.from_numpy(np.ascontiguousarray(dst_all[idx])).to(dev),
            torch.from_numpy(np.ascontiguousarray(edge_all[idx])).to(dev),
        )

    def k1_plain(s, d, e):
        return _fused_score_plain(mat, s, d, e, mlp.w0c, mlp.w0p, mlp.w0e, mlp.b0,
                                  mlp.layers())

    k1_err = {}
    for n in (128, 256, 512, 4096):
        s, d, e = k1_inputs(n)
        got = fused_gather_mlp_score(mat, s, d, e, mlp)
        torch.cuda.synchronize()
        want = k1_plain(s, d, e)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        k1_err[n] = err
        check(bool(torch.isfinite(got).all()), f"K1 non-finite at n={n}")
        check(err <= K1_TOL * scale, f"K1 off its plain version by {err} at n={n}")
    c512 = torch.from_numpy(np.ascontiguousarray(comps[np.arange(512) % len(comps)])).to(dev)
    got = rule_sum(c512)
    torch.cuda.synchronize()
    want = _rule_sum_plain(c512, RULE_COMPONENT_WEIGHTS)
    k2_err = float((got - want).abs().max())
    check(k2_err <= K2_TOL, f"K2 off its plain version by {k2_err}")
    emit({"phase": "kernels", "k1_max_abs_err": k1_err, "k1_tol_scaled": K1_TOL,
          "k2_max_abs_err": k2_err, "k2_tol": K2_TOL})

    # -- 5. times -----------------------------------------------------------
    d1, d2 = mlp.w0c.shape[1], mlp.w1.shape[1]
    # Timing launches are not path launches: counted apart.
    floor_ms = device_ms(lambda: torch.cuda._sleep(1))
    k1_times = {}
    for n in (128, 512):
        s, d, e = k1_inputs(n)
        k1_times[n] = (device_ms(lambda: fused_gather_mlp_score(mat, s, d, e, mlp)),
                       device_ms(lambda: k1_plain(s, d, e)),
                       bound(*k1_cost(n, d1, d2, mlp.k1_blob.numel())))
    k1_ms, k1_plain_ms, (k1_bound, k1_by) = k1_times[512]
    # K2 on its row ladder, each rung tiled from the rule arm's components
    # and held to its plain version (also on the view one row in).
    k2_rungs = k2_ladder(comps, dev, floor_ms=floor_ms)["rungs"]
    for n, r in k2_rungs.items():
        err = max(r["max_abs_err"], r["max_abs_err_offset_view"])
        check(err <= K2_TOL, f"K2 off its plain version by {err} at {n} rows")
    k2_512 = k2_rungs[512]
    k2_ms, k2_plain_ms, k2_lib_ms = k2_512["ms"], k2_512["plain_ms"], k2_512["library_ms"]
    k2_bound, k2_by = k2_512["bound_ms"], k2_512["bound_by"]
    # The card's busy share of the concurrent phase, from K1's device time
    # at 128 rows (the pad most flushes take).
    busy_s = concurrent["k1_launches"] * k1_times[128][0] / 1e3
    emit({"phase": "times", "concurrent_wall_s": timing["wall"],
          "k1_device_s": busy_s, "device_busy_share": busy_s / timing["wall"],
          "launch_floor_ms": floor_ms,
          "k1": {n: {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2][0],
                     "share_of_bound": t[2][0] / t[0], "over_launch_floor": t[0] / floor_ms}
                 for n, t in k1_times.items()},
          "k2": {"ms": k2_ms, "over_launch_floor": k2_ms / floor_ms, "ladder": k2_rungs}})

    # -- 6. training path ---------------------------------------------------
    k3_entry, training, work = train_phase(torch, dev, args.seed)

    # -- 7-9. the learned-scheduling loop -----------------------------------
    loop = {"stream": stream_phase(torch, dev, args.seed, work_dir),
            "lifecycle": lifecycle_phase(dev),
            "rollout_serving": rollout_serving_phase(dev, args.seed, work_dir)}

    # -- 10-11. the flagship and the trainer service ------------------------
    loop["hop"] = hop_phase(torch, dev, args.seed, work, training["metrics"])
    loop["trainer_service"] = trainer_service_phase(torch, dev, args.seed, work_dir)
    service_k3 = loop["trainer_service"]["gat_kernel_launches"]["segment_sum"]
    service_k3_err = loop["trainer_service"]["k3"]["max_abs_err"]
    k3_entry.update({"launches_training": k3_entry["launches"],
                     "launches_service_gat": service_k3,
                     "max_abs_err_service_gat": service_k3_err,
                     "ms_service_gat": loop["trainer_service"]["k3"]["ms"],
                     "plain_ms_service_gat": loop["trainer_service"]["k3"]["plain_ms"],
                     "library_ms_service_gat": loop["trainer_service"]["k3"]["index_add_ms"],
                     "bound_ms_service_gat": loop["trainer_service"]["k3"]["bound_ms"]})
    k3_entry["launches"] += service_k3
    k3_entry["max_abs_err"] = max(k3_entry["max_abs_err"], service_k3_err)

    # -- 12-13. the record and probe half, GraphSAGE on its probe graph -----
    loop["swarm"], sim = swarm_phase(torch, dev, args.seed, work_dir)
    loop["sage"], sage_k3, sage_k3_err = sage_phase(torch, dev, args.seed, sim)
    del sim
    k3_entry.update({"launches_sage": sage_k3, "max_abs_err_sage": sage_k3_err,
                     "ms_sage_d44": loop["sage"]["k3"][44]["ms"],
                     "ms_sage_d128": loop["sage"]["k3"][128]["ms"]})
    k3_entry["launches"] += sage_k3
    k3_entry["max_abs_err"] = max(k3_entry["max_abs_err"], sage_k3_err)

    # -- 14-15. the online graph trainer and federated FedAvg ---------------
    loop["online_graph"] = online_graph_phase(torch, dev, args.seed, work_dir)
    loop["federated"] = federated_phase(torch, dev, args.seed)

    # -- 16. the deployment over real sockets --------------------------------
    loop["wire_loop"], wire_launches = wire_loop_phase(torch, dev, args.seed, work_dir)
    wire = loop["wire_loop"]
    # -- 17. the self-driving lifecycle over real sockets --------------------
    loop["wire_lifecycle"], lc_launches = wire_lifecycle_phase(torch, dev, args.seed, work_dir)
    lc = loop["wire_lifecycle"]
    k3_entry.update({"launches_wire_gat": wire_launches["segment_sum"],
                     "max_abs_err_wire_gat": wire["k3"]["max_abs_err"],
                     "ms_wire_gat": wire["k3"]["ms"], "bound_ms_wire_gat": wire["k3"]["bound_ms"]})
    k3_entry["launches"] += wire_launches["segment_sum"]
    k3_entry["max_abs_err"] = max(k3_entry["max_abs_err"], wire["k3"]["max_abs_err"])

    # -- 18. multi-device training on torch.distributed ---------------------
    loop["multidevice"], md_k3, md_k3_err = multidevice_phase(
        torch, dev, args.seed, work_dir, work, training, loop["hop"])
    del work
    k3_entry.update({"launches_multidevice_gat": md_k3,
                     "max_abs_err_multidevice_gat": md_k3_err})
    k3_entry["launches"] += md_k3
    k3_entry["max_abs_err"] = max(k3_entry["max_abs_err"], md_k3_err)

    # -- 19. tracing, telemetry and tenant QoS on the K1 serving path --------
    loop["telemetry_qos"], tq_launches = telemetry_qos_phase(torch, dev, args.seed, work_dir)
    tq = loop["telemetry_qos"]
    # -- 20. the peer daemon's download path, K1 ranking parents -------------
    loop["peer_swarm"], ps_launches = peer_swarm_phase(torch, dev, args.seed, work_dir)
    ps = loop["peer_swarm"]
    # -- 21. preheat and the seed peer, K1 ranking seed parents --------------
    loop["preheat_swarm"], ph_launches = preheat_phase(torch, dev, args.seed, work_dir)
    ph = loop["preheat_swarm"]
    # -- 22. the sharded scheduler fleet, K1 in each ml shard ----------------
    loop["shard_fleet"], sf_launches = shard_fleet_phase(torch, dev, args.seed, work_dir)
    sf = loop["shard_fleet"]
    # -- 23. the push-reschedule path, K1 ranking pushed parents -------------
    loop["push"], push_launches = push_phase(torch, dev, args.seed, work_dir)
    pu = loop["push"]
    # -- 24. the tenant QoS overload drill (K1) and the telemetry drills -----
    loop["qos_drill"], qd_launches = qos_drill_phase(torch, dev, args.seed, work_dir)
    qd = loop["qos_drill"]
    # -- 25. the trainer service across ranks, K3 in every rank's GAT -------
    loop["trainer_ranks"], tr_k3, tr_k3_err = trainer_ranks_phase(
        torch, dev, args.seed, work_dir)
    k3_entry.update({"launches_trainer_ranks": tr_k3[:-1],
                     "launches_trainer_ranks_one_device": tr_k3[-1],
                     "max_abs_err_trainer_ranks": tr_k3_err})
    k3_entry["launches"] += sum(tr_k3)
    k3_entry["max_abs_err"] = max(k3_entry["max_abs_err"], tr_k3_err)
    # -- 26. image pulls through the registry proxy and the object gateway --
    loop["registry_proxy"], rp_launches = registry_proxy_phase(torch, dev, args.seed, work_dir)
    rp = loop["registry_proxy"]
    # -- 27. the secured cluster: CA, PATs, mTLS, the SNI proxy (K1) ---------
    loop["secure_cluster"], sc_launches = secure_cluster_phase(
        torch, dev, args.seed, work_dir)
    sc = loop["secure_cluster"]
    # -- 28. manager HA: the leader SIGKILLed, K1 serving through it --------
    loop["manager_failover"], mf_launches = manager_failover_phase(
        torch, dev, args.seed, work_dir)
    mf = loop["manager_failover"]
    # -- 29. the port's own deployment: run_local at its defaults -----------
    loop["deploy"], dp_launches = deploy_phase(work_dir)
    kernels = {"kernels": [
        {"name": "fused_gather_mlp_score", "route": "cuda",
         "source": "dragonfly2_tpu_torch/csrc/fused_score.cu",
         "replaces": "dragonfly2_tpu/ops/pallas_score.py:114",
         "launches": launches["fused_gather_mlp_score"]
         + wire_launches["fused_gather_mlp_score"] + lc_launches["fused_gather_mlp_score"]
         + tq_launches["fused_gather_mlp_score"] + ps_launches["fused_gather_mlp_score"]
         + ph_launches["fused_gather_mlp_score"] + sf_launches["fused_gather_mlp_score"]
         + push_launches["fused_gather_mlp_score"] + qd_launches["fused_gather_mlp_score"]
         + rp_launches["fused_gather_mlp_score"] + sc_launches["fused_gather_mlp_score"]
         + mf_launches["fused_gather_mlp_score"] + dp_launches["fused_gather_mlp_score"],
         "launches_serving": launches["fused_gather_mlp_score"],
         "launches_wire": wire_launches["fused_gather_mlp_score"],
         "launches_wire_lifecycle": lc_launches["fused_gather_mlp_score"],
         "launches_telemetry_qos": tq_launches["fused_gather_mlp_score"],
         "launches_peer_swarm": ps_launches["fused_gather_mlp_score"],
         "launches_peer_swarm_python_arm": ps["k1"]["launches_python_arm"],
         "launches_preheat": ph_launches["fused_gather_mlp_score"],
         "launches_shard_fleet": sf_launches["fused_gather_mlp_score"],
         "launches_push": push_launches["fused_gather_mlp_score"],
         "launches_qos_drill": qd_launches["fused_gather_mlp_score"],
         "launches_registry_proxy": rp_launches["fused_gather_mlp_score"],
         "launches_secure_cluster": sc_launches["fused_gather_mlp_score"],
         "launches_manager_failover": mf_launches["fused_gather_mlp_score"],
         "launches_deploy": dp_launches["fused_gather_mlp_score"],
         "max_abs_err": max(k1_err.values()), "max_err_scaled_wire": wire["k1"]["max_err_scaled"],
         "max_err_scaled_wire_lifecycle": lc["k1"]["max_err_scaled"],
         "max_err_scaled_telemetry_qos": tq["k1"]["max_err_scaled"],
         "max_err_scaled_peer_swarm": ps["k1"]["max_err_scaled"],
         "max_err_scaled_preheat": ph["k1"]["max_err_scaled"],
         "max_err_scaled_shard_fleet": sf["k1"]["max_err_scaled"],
         "max_err_scaled_push": pu["k1"]["max_err_scaled"],
         "max_err_scaled_qos_drill": qd["k1"]["max_err_scaled"],
         "max_err_scaled_registry_proxy": rp["k1"]["max_err_scaled"],
         "max_err_scaled_secure_cluster": sc["k1"]["max_err_scaled"],
         "max_err_scaled_manager_failover": mf["k1"]["max_err_scaled"],
         "max_err_scaled_stress": pu["k1_stress"]["max_err_scaled"],
         "stress_launches": pu["k1_stress"]["launches"],
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "share_of_bound": k1_bound / k1_ms, "ms_128": k1_times[128][0],
         "bound_ms_128": k1_times[128][2][0], "ms_wire_128": wire["k1"]["ms_128"],
         "ms_wire_lifecycle_128": lc["k1"]["ms_128"],
         "ms_telemetry_qos_128": tq["k1"]["ms_128"],
         "ms_peer_swarm_128": ps["k1"]["ms_128"],
         "ms_preheat_128": ph["k1"]["ms_128"],
         "ms_shard_fleet_128": sf["k1"]["ms_128"],
         "ms_push_128": pu["k1"]["ms_128"],
         "ms_qos_drill_128": qd["k1"]["ms_128"],
         "ms_registry_proxy_128": rp["k1"]["ms_128"],
         "ms_secure_cluster_128": sc["k1"]["ms_128"],
         "ms_manager_failover_128": mf["k1"]["ms_128"]},
        {"name": "rule_weighted_sum", "route": "cuda",
         "source": "dragonfly2_tpu_torch/csrc/fused_score.cu",
         "replaces": "dragonfly2_tpu/ops/pallas_score.py:364",
         "launches": launches["rule_weighted_sum"] + dp_launches["rule_weighted_sum"],
         "launches_deploy": dp_launches["rule_weighted_sum"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib_ms,
         "share_of_bound": k2_bound / k2_ms,
         "ladder": {n: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                          "share_of_bound", "max_abs_err")}
                    for n, r in k2_rungs.items()}},
        k3_entry,
    ]}
    k3_entry["launches_deploy"] = dp_launches["segment_sum"]
    k3_entry["launches"] += dp_launches["segment_sum"]
    for entry in kernels["kernels"]:
        entry["launch_floor_ms"] = floor_ms
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_nvcc.txt"), "w") as f:
            f.write(_build.build_log)
        with open(os.path.join(args.out, "chip_smoke_kernels.json"), "w") as f:
            json.dump({"card": card, **kernels, "training": training, **loop}, f, indent=1)
    print(card, flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
