"""Smoke run of isle_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from isle_tpu_torch/csrc, trains at the NYTimes shape (vocab 102,660, docs
300,000, 48M nnz, k = 100, edge topics max 2000, the random corpus of
isle_tpu_torch.synth from a seed), holds each kernel against its plain
PyTorch version on the main path's own streams, and infers the same
documents with the trained model (MWU, ISLEInfer's path).

    python3 chip_smoke.py [--docs N] [--seed S] [--pubmed-docs N]

--docs cuts the number of documents (the nnz scales with it; vocab and k
stay) and says so on its own line; --pubmed-docs does the same for
phases P and Q. Phases, in order:

  1. the card (nvidia-smi name and power limit) and torch/CUDA versions;
  2. the kernel build, timed, with ptxas's registers and spills per
     kernel (a spill fails the run);
  3. a small corpus (the TINY shape below) trained on the card and on
     the CPU (plain versions): equal clusters, eigenvalues within rtol
     1e-4, models within rtol 1e-4, atol 1e-6, top-two topics per doc
     equal but where the doc's catchword masses tie (check_tiny);
  4. the main path: Trainer.train() + train_edge_topics() at the NYTimes
     shape with the launch counts reset just before and read just after;
     then three more training runs of the same corpus and seed: their
     walls, and each one's clusters, catchwords, doc-topic mass, centers,
     model and edge model REQUIRED equal to the first run's, bit for bit
     (no float atomics are left on the path, the projected Lloyd's sums
     by a one-hot matmul, and k-means++ takes its cumulative sum on the
     host); in turn with them, two runs on the dispatch before the narrow
     kernel and the tiled passes (walls, eigensolve and peak printed,
     eigenvalues within rtol 1e-4); beside them, how many distinct
     results torch.cumsum gives on the card for 200 launches on one
     vector of the corpus's doc count (printed: it is why that sum left
     the card);
  5. kernel against plain version on the main path's streams, each use
     timed with CUDA events beside its bound (bytes: the stream, the
     table and the output once, at 3.35 TB/s; operations at 67 TFLOP/s
     float32) and one PyTorch library call for the same function:
     segsum_onehot's ζ histogram, r-th group counts, doc-topic mass and
     doc norms of B (library: index_put_ with accumulate=True; the doc
     norms take no column array, and sparse.doc_l2sq is also timed whole
     beside the index_add_ it replaced), each with the row window of its
     kernel, counts exactly equal, sums within rtol 1e-5 of the plain
     version in float64 (the kernel sums in float64 in its own fixed order
     and rounds each cell once),
     and two launches bit-equal;
     segsum_gather_rows's model SpMM B W (width
     100), eigensolver B^T X and B Y (width 128) and Lloyd's B^T C and
     B onehot (width 100) on the thresholded matrix B (library:
     torch.sparse.mm on a CSR copy of the stream, built outside the
     timed window), each element within 1e-5 |B| |X| of the plain
     version in float64 (|B| |X|: the plain version on absolute values;
     Krylov blocks have mixed signs), and two launches bit-equal; B Y
     and B onehot also through the tiled passes over B's doc tiles (the
     trainer tiles B; segsum.gather_path sends them there), held as well
     within 1e-5 |B| |X| of the untiled kernel and timed beside it;
  6. checks of the result: segsum_onehot launched at least once per
     use on the main path, segsum_gather_rows at least twice per
     eigensolver operator call and
     per full-space Lloyd's iteration plus the projection and the model
     SpMM, every model column sums (in float64) to 1 within 1e-5 or is
     all zero, eigenvalues finite and descending, at least one
     catchword;
  7. each training option beyond the defaults (document sampling at rate
     0.5, Elkan's, k-means||, AFK-MC^2, centers from the seed columns of
     B, use_explicit_projected_matrix=False) on the small corpus with
     the dense eigensolver and torch's deterministic algorithms (block
     KS and atomics are phase 3's), card against CPU
     with the tolerances of phase 3, and an inference of the small corpus
     with its model: convergence flags equal, weights within rtol 1e-4,
     atol 1e-6;
  8. inference at full width: the NYTimes docs normalized to unit mass,
     inferred with phase 4's model (iters 15, Lf 10) twice, top 5 per doc
     as the CLI reads them and full weights: wall time, the card pack's
     time, converged share, average LLHs, peak device memory. Checks:
     every converged row of the full weights sums to 1 within 1e-2, the
     LLHs are finite, at least 90% of docs converge, and on a fixed
     sample of 2,048 docs the card's weights equal a float64 CPU run of
     the plain MWU core within atol 1e-4 with the same convergence flags.
     Whether the two runs' weights are bit-equal is printed. MWU reaches
     no segsum kernel (those launch counts are printed, not required);
     each run packs its batch on the card, one launch of each pack
     kernel (counted from zero before the run, required).

  E. (between 6 and H1) the eigensolver's two loops on phase 4's B
     (rebuilt from the run's ζ, with its doc tiles): linalg.block_ks_device
     (the default: the Ritz step a float64 eigh on the card) and
     linalg.block_ks (the host-driven loop, LAPACK float32), the same
     draws, three solves each in turn, launch counts set to 0 just before
     and read just after every solve. Gates: the device loop's solves
     bit-equal to each other and its eigenvalues to phase 4's; nconv,
     restarts, operator calls and launch counts equal between the loops;
     eigenvalues within rtol 1e-4 and U within atol 2e-4 up to sign; a
     restart of the device loop waits on the host only for the stop test
     and for eigh's own check (torch.cuda.set_sync_debug_mode("warn"),
     recorded warnings: a full solve's waits less a max_restarts=0
     solve's, over its restarts, equal eigh's waits plus one); two float64
     eighs bit-equal. Printed: the waits of both loops, the Ritz eigh alone
     on the card and LAPACK's on the host, the median walls, the peak
     memory, and one traced solve of each loop (torch.profiler: device
     idle time and the split of M4). With H4, the k = 64 corpus trained
     in each layout with the device loop against H4's host-loop run of
     the layout: eigenvalues within rtol 1e-4, and clusters equal on more
     than 99% of docs where the k-means++ seeds are equal; where they
     part, only at a tie of a draw (the first differing seed the next or
     the previous doc), the agreement then printed with and without the
     labels;
  H1. (between E and 7) the hybrid layout, the port's default engine
     (GpuConfig's dense_head_bytes, 4 GiB, as isle_tpu's): first the
     small corpus with a 200-row head, card against CPU as in phase 3;
     then Trainer.train() + train_edge_topics() at the NYTimes shape
     with the default configuration, launch counts and head GEMMs set
     to 0 just before and read just after: ζ and original_cols equal
     phase 4's (COO), eigenvalues within rtol 1e-4 of it, the launches
     of the stages the layout does not change equal phase 4's; three
     more runs bit-equal to the first; the layout rebuilt from the
     run's ζ: its head rows by isle_tpu's rule, its head words equal to
     a host recomputation (ties to the lower word id), its head nnz the
     host's count; h_bt_x and h_b_y at width 128 each within 1e-5
     ||B|| ||X|| (Frobenius) of the float64 COO product on the same X,
     the largest elementwise error over |B| |X| printed; whole-call times
     beside the COO bt_x / b_y / doc_l2sq; the head product alone
     (one bf16 GEMM with a float32 output over three bf16 pieces) at
     widths 128, 100 and 1 both ways against its plain version and its
     bound (the head read once at 3.35 TB/s, or 3 x 2 R D W operations at
     the 989 TFLOP/s bf16 peak), two launches bit-equal; the tail's uses
     of both kernels as phase 5 times them, its B Y and B onehot through
     the tiled passes (5 doc tiles of 65,536) and the untiled kernel.
     Two more runs on the dispatch before the narrow kernel and the
     tiled passes, in turn with the repeated runs (eigenvalues within
     rtol 1e-4). Printed, not gated: how far clusters and catchwords
     moved from the COO run, the walls of both dispatches.
  HC. (right after H1) GpuConfig.break_head_cap, the head past isle_tpu's
     int32 row cap: Trainer.train() + train_edge_topics() at the NYTimes
     shape with dense_head_bytes 8 GiB and 16 GiB and the switch (R =
     14,316 and 28,633 by the rule min(vocab, budget // (2 docs)),
     against the cap's 7,153), launch counts set to 0 just before each
     and read just after (the "head-past-cap" path of the kernels line);
     each: ζ and original_cols equal phase 4's, eigenvalues within rtol
     1e-4 of it, model columns summing to 1 within 1e-5, the stages the
     layout does not change launching what phase H1's did. Each run's
     layout is rebuilt from its ζ, and the layout at 8 GiB without the
     switch (R = 7,153, the cap): head words equal the host's, the
     head's row sums counted on the card in float32 equal the host's
     counts, head nnz + tail nnz = nnz(B), h_bt_x and h_b_y at width 128
     within 1e-5 ||B|| ||X|| of the float64 COO product, two h_gram_x
     bit-equal. Printed for R = 0 (phase 4) / 7,153 (H1) / 14,316 /
     28,633: the head's share of nnz, the build's seconds, the head and
     the tail part of h_bt_x and h_b_y at width 128 each beside its
     bound, the eigensolve, k-means and train + edge walls, the peak.
  H4. (right after HC) the layouts against each other where the clusters
     are well defined: the NYTimes shape at k = 64 (the synthetic corpus
     plants 64 word bands), trained in the default hybrid layout and in
     COO, both on the host eigensolver loop (with the device loop the COO
     run's k-means++ parts from the host loop's at a tie of a draw):
     clusters equal on more than 99% of docs and eigenvalues within
     rtol 1e-4 (tests/test_variants.py's cross-layout bounds); the
     model's max abs difference and the topics with equal catchwords
     printed.

Between 7 and 8, with the in-core corpus off the card:

  M1. the sharded trainer (Trainer with a sharding.Mesh) at world size 1
     over a one-rank NCCL group whose rendezvous is a file under the
     output directory (if torch.distributed has no NCCL the line says so
     and the mesh has no group), at the NYTimes shape with edge topics,
     launch counts reset just before and read just after, torch's
     library SpMM and sparse constructors made to raise meanwhile: ζ,
     original_cols, clusters and catchword sets equal phase 4's exactly,
     the model within 1e-6; every stage's launches (Trainer.stage_launches)
     equal the in-core stage's; wall, stage walls, peak device memory, the
     collectives' count and the time inside them;
  T.  sharding.sharded_train_step over the same mesh on the rank's B (the
     run's ζ), X (V, 128) from the seed and phase 4's final centers: one
     warm-up and five steps timed with CUDA events (median), launch counts
     reset just before and read just after (a step: 4 segsum_gather_rows,
     2 segsum_onehot), 4 collectives a step, their time and the peak. Y
     bit-equal to sparse.gram_x, assign to kmeans._assign on the same dots,
     new_centers to kmeans.update_centers_full, hist to np.bincount of the
     words, the six steps bit-equal; the step's new use of segsum_onehot,
     the word histogram, against its plain version (exactly, two launches
     bit-equal) beside its bound and torch.bincount. Then
     graft_entry.entry() on the card against entry("cpu") (Y within 1e-5
     |B| |X|, assignments equal but on ties within rtol 1e-5, centers and
     MWU weights within 1e-5) and `python -m isle_tpu_torch.graft_entry
     --device cuda --dryrun 1` in a process of its own (exit 0, three OK
     lines);
  M2. doc-parallel inference over the same group on the first 20,000 docs
     against the single-device Inferencer: convergence flags equal,
     weights within rtol 2e-5;
  M3. the C shim (isle_tpu_torch/csrc/isle_capi_torch.cpp) built with g++
     and native/capi_smoke.c run against it with ISLE_CAPI_DEVICE=cuda;
  M4. one more in-core run with GpuConfig.profile_dir: the Chrome trace
     must exist and hold CUDA kernel events and a marker for every stage;
     from it, how the eigensolve's time (the default loop,
     block_ks_device) splits into the SpMM kernels, the Ritz eigh, QR,
     the orthogonalization matmuls, other kernels, copies and idle device
     time (printed beside the host loop's 292 ms in an earlier trace of
     this stage on an H100 80GB HBM3 at 700 W), with the
     host's time in eigh, QR, the matmuls and synchronizes;

  S1. streamed training (isle_tpu_torch.streaming.StreamedTrainer) of the
     same corpus at full width, chunk_entries 2^22 (12 chunks), launch
     counts reset just before and read just after: ζ, original_cols and
     B exactly equal to the in-core stages', eigenvalues within rtol 1e-4
     of phase 4's, model columns sum to 1 within 1e-5; stage walls, train
     wall, peak device memory, bytes copied to the card and the share of
     the wall spent waiting for copies. The launch counts are read at
     the end of every stage (Trainer.stage_launches), and each streamed
     pass must have launched its kernel exactly once a chunk: the
     histogram, the mass and the model accumulation, and nothing in the B
     construction. Then a second StreamedTrainer
     resumes from phase 4's ckpt_svd.npz and ckpt_kmeans.npz: the same
     catchwords, the same top-two topics but where a doc's two masses tie
     (within rtol 1e-5: the chunks shift the kernel's order of summing),
     the model within rtol 1e-4, atol 1e-6. Then a third trains with
     document sampling at rate 0.5, the case in which B shrinks to fit
     the card: the sampling weights launch once a chunk as well, ζ
     equals the in-core run's, and the sampled docs and B equal the
     in-core stage's with the same draws (a doc may flip only where its
     dice ties the pivot within rounding);
  S2. the streamed uses of both kernels on a middle chunk against their
     plain versions, as phase 5 does it: the ζ histogram and the model
     accumulation with the carry of the chunks before as `init`, the
     doc-topic mass and the sampling weights on the chunk's local doc ids
     (and the mass once more with a non-zero init); the bound counts the
     chunk's stream, the chunk's rows of the table and the carry read
     and written once; the chunk's sort by word is timed beside them.
     Each use's launches are the counts read from S1's runs;
  S3. Lanczos: the small corpus with eigensolver="lanczos" card against
     CPU (as phase 7), and at the NYTimes shape linalg.lanczos on the
     streamed B against phase 4's block_ks eigenvalues within rtol 1e-3,
     with restarts, operator calls, wall and the width-1 launches' times,
     twice: as shipped (every width-1 matvec on the narrow kernel,
     segsum_gather_rows_narrow_kernel) and on the dispatch before it (the
     wide kernel at width 1), each wall printed. Then the narrow kernel
     against the wide one at widths 1, 2, 4, 8 and 16 on B's two streams,
     each against its plain version as phase 5 does it: the crossover
     segsum.NARROW_MAX_WIDTH is set from;
  S4. the reports on the small corpus, card against CPU:
     A_squared_spectrum.txt within rtol 1e-4, M_hat_avg within 1e-5, edge
     topics v1 within 1e-5 with the same selected pairs;
  S5. out of core over the mesh: a StreamedTrainer with M1's one-rank
     NCCL mesh (isle_tpu_torch/streaming_sharded.py: the rank streams its
     doc range, the histogram and the model are all-reduced, the model
     thresholds come from the distributed rank selection) at the NYTimes
     shape with edge topics, chunk_entries 2^22, launch counts reset just
     before and read just after, torch's library SpMM made to raise: ζ,
     original_cols, the rank's B (both sort orders), clusters, catchword
     sets and top-two topics equal S1's exactly, the model and the edge
     model within 1e-6 (bit-equality printed); every streamed pass
     launched its kernel exactly once a chunk and the middle's stages
     launched what S1's did; wall, stage walls, peak device memory, bytes
     copied, the copy-wait share and the collectives' count and time;
  H2. the sharded trainer with the hybrid layout (sharding.shard_hybrid)
     over M1's mesh: ζ, original_cols, clusters and catchwords equal
     H1's, the model within 1e-6, the eigensolve, the projection and
     k-means launching what H1's did;
  H3. the 12-chunk StreamedTrainer with the hybrid layout: ζ and
     original_cols equal H1's, eigenvalues within rtol 1e-4, every
     streamed pass one launch a chunk.
  R.  the resident corpus (streaming.ResidentLoader, the default loader:
     S1-S5 and H3 set resident_corpus_bytes=0 and measure the wire
     loader) and the middle's memory plan, each run with the launch
     counts reset just before and read just after and every streamed
     pass one launch a chunk: the default run (COO) equal to S1's bit
     for bit (ζ, original_cols, B, clusters, catchwords, top-two topics,
     model, edge model), one fill, every chunk's values equal to
     corpus.vals bit for bit, bytes copied against S1's, the fill's
     seconds, stage walls, wall and peak; the default hybrid run, held,
     equal to H3's; then GpuConfig.hbm_bytes at 8, 4 and 2 GiB with the
     default head budget: the head shrunk by plan_middle_budget (the
     head rows built equal the plan's, eigenvalues within rtol 1e-4 of
     the full head's), the slabs kept with no head (equal to S1's), the
     slabs released before the middle and filled again (two fills, equal
     to the held run's); last the sharded streamed trainer over M1's
     mesh on the resident loader, equal to S5's. A cut corpus takes, in
     place of a size that does not give its outcome, the hbm_bytes that
     gives it, on a CUT line. Last a real out-of-memory retry: the
     default hybrid run once more with a ballast tensor placed at the
     middle's start that leaves OOM_FREE_BYTES free and goes with the
     failed attempt (ballast_middle): the first attempt must raise
     torch.OutOfMemoryError with the slabs held, planned_middle's one
     retry must finish with them released (two fills), equal to the
     released run bit for bit;
  Z.  the bite corpus (isle_tpu_torch.synth.bite_counts: phase 4's pairs
     with Zipf(2) counts capped at 1000 and every doc d % 100 == 7 flat
     but its first entry; 824 ζ histogram columns, ζ above 1 on 130
     words, nnz(B) 38,008,938, counts uint16) at k = 100, every run with
     the launch counts set to 0 just before and read just after.
     Z1 in core (COO): ζ, nnz(B) and original_cols equal isle_tpu's
     results pinned in BITE_PINS (full shape and seed 0 only; a cut
     corpus prints them on a CUT line), B equal to threshold_and_copy run
     on the CPU on a host copy of A, the result checks of phase 6, each
     kernel at this corpus's shapes as phase 5 does it (launches at least
     the uses), the stage table. Z2 the default hybrid layout: ζ and
     original_cols equal Z1's, eigenvalues within rtol 1e-4, the cluster
     agreement with Z1 printed. Z5 each drop flag alone: ζ (+inf count),
     nnz(B) and original_cols equal the pins, the result checks. Z6 every
     entry of OPTIONS and Lanczos on the default eigensolver: the result
     checks, segsum_onehot launched at least 4 times and
     segsum_gather_rows at least twice an operator call plus 2; Elkan's
     on the same clusters as Z1's Lloyd's for at least ELKANS_AGREEMENT
     of docs (its bound arrays' bytes printed); the explicit projected
     matrix off equal to Z1 bit for bit; the others' agreement printed.
     Z4 the sharded trainer over M1's mesh, held to Z1 as M1 to phase 4.
     Z3 out of core in 12 chunks on the wire and the resident loader
     (which must keep the counts as uint16, every chunk's values equal to
     corpus.vals, the run equal to the wire run bit for bit): ζ,
     original_cols and B equal Z1's, eigenvalues within rtol 1e-4, the
     model within 1e-6; then both sampled at 0.5 as S1's third part,
     resident equal to wire bit for bit, and original_cols equal to Z6's
     in-core sampled run, eigenvalues within rtol 1e-4, the model within
     1e-6. Z7 inference of the 300,000 docs with Z1's model as phase 8,
     the top-5 run's weights required equal to the full run's;

After 8:

  C.  both CLIs as a user runs them, on phase 4's corpus. C0 the corpus
     written as a 1-based TDF file by the port's native triple writer
     and a vocab file of one line a word (sizes and seconds printed).
     C1 `python -m isle_tpu_torch.cli.train <tdf> <vocab> <out> <vocab>
     <docs> 0 <k> 0 0 0 1 <edges> --seed S` in a process of its own (the
     card and GpuConfig's defaults): exit code 0, its start line naming
     cuda and the native text I/O; Corpus.from_tdf_file of the file in
     this process equal to phase 4's corpus (offsets, rows, counts,
     vals, avg_doc_sz, nz_docs); the TrainConfig of the 12 arguments and
     GpuConfig() equal phase H1's, and the CLI's ckpt_svd, ckpt_kmeans
     and ckpt_model.npz equal H1's run bit for bit (so the CLI ran the
     kernels H1's launch counts gate; the CLI logs no counts); every
     result file of its run directory byte-equal to the port's writers
     run in this process on H1's trainer into another directory, and the
     cluster summary's messages equal, the logs (timings, paths) alone
     left out; each file's bytes and lines, the CLI's stage split (its
     Timer), its wall from launch to exit, peak RSS and peak device
     memory printed. C2 `python -m isle_tpu_torch.cli.infer <run>/
     M_hat_catch_sparse <tdf> <out2> <k> <vocab> 1 <docs+1> <nnz> 0 0 0`:
     exit code 0, cuda and native; the report
     top_topics_iters_15_Lf_10.000000_doc_1_to_<docs+1> byte-equal to one
     written in this process (an Inferencer on the same model file,
     infer_corpus(top_n=5), io_text.write_top_topics), or else the same
     (doc, topic) lines but at ties within 1e-6 and the weights within
     1e-4, how they differ printed; the converged count equal and the two
     average LLHs within 1e-6 relative of the in-process ones; how far the
     model read back from the text file is from C1's in memory (and the
     entries under the writer's 1e-8 cut) printed, with the stage split,
     wall and RSS. The files are removed at the end;

With the NYTimes corpus freed:

  M. the micro-benchmarks' kernels (isle_tpu_torch/micro_kernels.py,
     csrc/micro.cu): both drivers' work (isle_tpu_torch/benchmarks/
     micro_pallas.py at n = 2^24, W = 128, chunk 2048 over its two
     segment streams and three modes; micro_pallas_gather.py at n = 2^22
     rows of a 102,660 x 128 table over its four (chunk, depth)), every
     launch count set to 0 just before and read just after (path
     "micro"); then per stream the rank plan equal to its host version,
     per mode the partials kernel within maxrel 1e-6 (max |out - ref| /
     max |ref|) of its plain version, two launches bit-equal, rows at
     unused ranks exactly zero, the partials plus the scatter within
     maxrel 1e-6 (highest) and 1e-5 (split2) of float64 sums; the gather
     bit-equal to index_select at every (chunk, depth), twice. Printed:
     the plan's, the kernel's, the partials + scatter's, index_add_'s,
     segsum_gather_rows(arange)'s and the plain version's ms beside the
     bound (g, the ranks and the partials once at 3.35 TB/s, or the dense
     one-hot product's bf16 operations at 989 TFLOP/s), each kernel's
     share of its bound, its factor against the library call
     (index_add_, index_select) and its threads, shared memory,
     registers and blocks an SM (micro_kernels.kernel_info).

Then, with everything of the NYTimes phases off the card:

  P.  isle_tpu's PubMed scale test (benchmarks/pubmed_scale.py: vocab
     141,043, 8.2M docs, an nnz target of 730M, k = 100, document
     sampling at rate 0.1, edge topics at most 2000, chunks of 2^25
     entries; --pubmed-docs N cuts the docs and the nnz target with them
     and says so on a CUT line). P0 the corpus: synth.synth_corpus_hashed
     on the card at a cut of the shape (PUBMED_PIN_CUT) and at the last
     draws of the full shape, REQUIRED to give the CPU's sha256 pins
     (PUBMED_PINS, made again by tests/test_torch_pubmed.py); then the
     corpus at the run's shape made on the card and built on the host
     (synth.corpus_from_csc): walls, nnz against the reference's ~787M,
     the largest doc, the chunks, host memory. P1 StreamedTrainer on
     GpuConfig's defaults (the resident loader, the memory plan, the
     hybrid middle, block_ks_device), every launch count set to 0 just
     before and read just after: one launch a chunk in every streamed
     pass, the resident loader with uint8 counts, the plan's decision
     (held slabs, the head budget, its rows) as planned_middle took it,
     the middle's peak in bytes a nonzero of B beside the plan's 96 and
     30, counts_dtype's seconds, the result checks of phase 6. P2 the
     same on the wire loader: the sampling mask, ζ, original_cols, B,
     clusters, catchwords, top-two topics, model and edge model equal
     P1's bit for bit. P3 Trainer in core on the same corpus: ζ,
     original_cols, B, the doc-topic mass (in core on A against the
     streamed pass), the top-two topics and the edge pairs equal P1's,
     eigenvalues within rtol 1e-4, model and edge model within 1e-6.
     P4 both kernels at these shapes, as phase 5 holds them: on P1's
     middle chunk the streamed ζ histogram and model accumulation (with
     `init`), the doc-topic mass and the sampling weights; the r-th
     group counts on the clustered docs' entries; on P1's hybrid tail the
     doc norms, Bᵀ·X and tiled B·Y at width 128, Bᵀ·C and tiled B·onehot
     at 100; and the head product beside them (cuBLAS, not a ported
     kernel). Then phase Q0 and Q1 (below). P5 ISLEInfer's path on all
     the docs with ISLETrain's model (Q1's file read back): the
     corpus normalized to unit mass (Corpus.normalized_to_one, as
     infer_file's reader normalizes), Inferencer.infer_corpus(top_n=5) on
     the card, the report written in blocks of
     inferencer.REPORT_BLOCK_DOCS docs by inferencer.write_report_blocks:
     the blocks' names as ISLEInfer's and their concatenation byte-equal
     to the report written as one file; at least 90% of docs converge,
     the LLHs finite; a fixed sample of 2,048 docs against a float64 CPU
     run of the plain MWU core (the kept top-5 weights within atol 1e-4,
     the same flags, none left out above a kept one); the first block
     inferred alone with every weight read back: the same flags, its
     converged rows summing to 1 within 1e-2, its top-5 rows within 1e-6
     of the whole run's (bit-equality printed); a tenth of the docs (a
     range of the benchmark's pubmed-infer) inferred alone: the same
     flags. Both pack kernels (csrc/pack.cu) at that range's shape and
     at the whole corpus's, against their plain versions on the same
     card tensors, bit for bit, two launches bit-equal, timed beside
     their bounds (and the host's numpy pack at the range); their
     launches counted from zero before the whole-corpus run and the
     range's, one each. Before the run the card's free memory beside
     the whole-corpus card pack's reckoned bytes (card_pack_bytes; the
     phase fails if it would not fit); printed the walls, the MWU
     blocks, the peak RSS and device memory. Each part's seconds are
     printed;
  Q.  both CLIs at PubMed's shape as a user runs them, from a TDF file.
     Q0 P0's corpus written as a 1-based TDF file by the port's triple
     writer and a vocab file, after a check that the disk holds what the
     phase reckons it writes (it fails naming the bytes). Then P1's
     streamed state and P3's trainer are freed (the parent's RSS and the
     host's MemAvailable printed at each CLI's start). Q1 `python -m
     isle_tpu_torch.cli.train <tdf> <vocab> <out> 141043 8200000 0 100 0
     1 0.1 1 2000 --seed S`: exit code 0 on cuda with the native text
     I/O, its TrainConfig and GpuConfig P3's, its ckpt_svd, ckpt_kmeans
     and ckpt_model.npz bit-equal to P3's, and every file it writes read
     back against P3's arrays: each file's lines equal the nonzeros they
     stand for (model and edge model entries above 1e-8, catchword
     entries, positive doc-topic masses, docs with top-two topics, edge
     topics, topics); the small files whole (edge pairs, top words); for
     the large ones the first and last lines and 4,096 lines at seeded
     byte offsets: ids in range and in the file's order, each value
     within its format's rounding (%.10f, %.6f) of P3's, the first and
     last lines P3's first and last entries. After P5 the corpus is
     freed; Q2 `python -m isle_tpu_torch.cli.infer <Q1's
     M_hat_catch_sparse> <tdf> <out2> 100 141043 1 8200001 <nnz> 0 0 0`:
     exit code 0 on cuda, native; its nine report blocks byte-equal to
     P5's (sha256), the converged docs and the average LLHs P5's. Each
     CLI's Timer split, wall from launch to exit, its own peak RSS and
     peak device memory, and its ingest's sort path printed;

Prints a JSON line of the kernels (per kernel: launches on the driven
paths (in-core, the three streamed runs and Lanczos, each also under
"launches_by_path", the sharded, the sharded streamed, the traced, the
three hybrid runs, phase HC's two runs, phase R's seven runs, phase Z's
runs, the train step's, graft_entry's, phase M's and phase P's among
them), max
error, and the sums of ms,
plain_ms, bound_ms and library_ms over the uses that a driven path
launched, every use
listed under "uses"). segsum_gather_rows counts every product call;
segsum_gather_rows_narrow and segsum_gather_rows_tiled (the narrow kernel
and the tiled passes of the wide one) count theirs, and each use's
launches are those of the kernel or mode it is listed under. Then the
card's line, and last
{"ok": true, "device": {...}}. Any failure raises (exit code 1); without a
CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import concurrent.futures
import contextlib
import datetime
import filecmp
import gc
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
NYT = dict(vocab=102_660, docs=300_000, nnz=48_000_000, k=100, edges=2000)
TINY = dict(vocab=2_000, docs=3_000, nnz=120_000, k=10, edges=20)
REPS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# kOhCells of csrc/segsum.cu: the cells of a warp's window of output rows
# in segsum_onehot, for counts (one row of the ζ histogram's 635 columns,
# or of the bite corpus's 824) and for float sums (5 rows of 100)
ONEHOT_WINDOW_CELLS = {"counts": 1024, "sums": 512}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# The training options beyond the defaults, run on the small corpus.
OPTIONS = {
    "sample_docs rate 0.5": dict(sample_docs=True, sample_rate=0.5),
    "elkans": dict(hyper=dict(kmeans_algo_for_sparse="elkans")),
    "kmeansbb": dict(hyper=dict(kmeans_init_method="kmeansbb")),
    "kmeansmcmc": dict(hyper=dict(kmeans_init_method="kmeansmcmc")),
    "enable_kmeans_on_lowd=False": dict(
        hyper=dict(enable_kmeans_on_lowd=False)),
    # the same product as the default in the port: run to show the option
    # is accepted
    "use_explicit_projected_matrix=False": dict(
        hyper=dict(use_explicit_projected_matrix=False)),
}
MWU_SAMPLE = 2048
STREAM_CHUNK_ENTRIES = 1 << 22
STREAM_SAMPLE_RATE = 0.5
ONEHOT, GATHER = "segsum_onehot", "segsum_gather_rows"
# the gather kernel's narrow kernel and its tiled mode (launch_counts keys)
NARROW, TILED = "segsum_gather_rows_narrow", "segsum_gather_rows_tiled"
# the widths at which phase S3 times the narrow kernel against the wide one
CROSSOVER_WIDTHS = (1, 2, 4, 8, 16)
# phase H4: the layouts held against each other at the synthetic corpus's
# 64 planted word bands
CROSS_LAYOUT_K = 64
# phase M: the micro-benchmarks' kernels (micro_kernels.py) at the shapes of
# benchmarks/micro_pallas.py and micro_pallas_gather.py
PARTIALS, ROWGATHER = "chunk_partials", "row_gather_async"
# the card pack of inference's batch (isle_tpu_torch/pack.py, csrc/pack.cu)
PACK_KEPT, PACK_FILL = "pack_kept_lengths", "pack_fill"
MICRO = dict(n=1 << 24, width=128, chunk=2048, gather_n=1 << 22,
             gather_rows=102_660)
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
# the arrays of a DocSparse's two sort orders
B_FIELDS = ("d_word", "d_doc", "d_val", "w_word", "w_doc", "w_val")


def synth_entries(shape: dict, seed: int):
    from isle_tpu_torch.synth import synth_corpus

    return synth_corpus(shape["vocab"], shape["docs"], shape["nnz"], seed)


def make_corpus(entries, shape: dict, normalize_to_one: bool = False):
    from isle_tpu_torch import Corpus

    d, w, c = entries
    # synth_corpus returns unique (doc, word) pairs in (doc, word) order
    return Corpus.from_entries(d, w, c, vocab_size=shape["vocab"],
                               num_docs=shape["docs"], sort_dedup=False,
                               normalize_to_one=normalize_to_one)


def gpu_config(device: str, head_bytes=0, **kw):
    """GpuConfig on `device` with the dense head budget `head_bytes`: 0
    (the COO layout) for every phase before H, None for GpuConfig's
    default (the hybrid layout, isle_tpu's default engine)."""
    from isle_tpu_torch import GpuConfig

    if head_bytes is not None:
        kw["dense_head_bytes"] = head_bytes
    return GpuConfig(device=device, **kw)


def train(corpus, shape: dict, seed: int, device: str, out: str,
          hyper=None, mesh=None, profile_dir: str = "", head_bytes=0,
          device_loop: bool = True, break_head_cap: bool = False,
          **cfg_kw):
    """Trainer.train() + train_edge_topics(); `device_loop` is
    GpuConfig.device_loop_solver (False: the host-driven block_ks),
    `break_head_cap` GpuConfig.break_head_cap."""
    from isle_tpu_torch import HyperParams, TrainConfig, Trainer

    cfg = TrainConfig(num_topics=shape["k"], seed=seed,
                      compute_edge_topics=True, max_edge_topics=shape["edges"],
                      hyper=HyperParams(**(hyper or {})), **cfg_kw)
    tr = Trainer(cfg, output_dir=out, quiet=True, mesh=mesh,
                 gpu=gpu_config(device, head_bytes, profile_dir=profile_dir,
                                device_loop_solver=device_loop,
                                break_head_cap=break_head_cap))
    tr.load_corpus(corpus)
    tr.train()
    tr.train_edge_topics()
    return tr


def time_ms(fn) -> float:
    """Mean milliseconds of fn() over REPS launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def tie_flips(gpu, cpu) -> tuple:
    """Docs whose top-two topics differ between the card and the CPU. The
    card sums a doc's catchword masses in another order than the CPU, so
    where two topics' masses tie the argmax may pick the other one:
    each such pick must have the mass of the CPU's pick within rtol 1e-5
    (the CPU's masses). Returns the doc ids and the largest relative gap
    between the two picks' masses."""
    from isle_tpu_torch.topic_model import doc_topic_mass

    g, c = gpu.top_pairs, cpu.top_pairs
    assert np.array_equal(g[2], c[2]), "top-two valid flags differ"
    flip = np.flatnonzero((g[0] != c[0]) | (g[1] != c[1]))
    gap = 0.0
    if flip.size:
        cwt = np.full(cpu.corpus.vocab_size, -1, np.int32)
        for t, words in enumerate(cpu.catchwords):
            cwt[words] = t
        mass = doc_topic_mass(cpu._device_A(), torch.as_tensor(cwt),
                              len(cpu.catchwords)).numpy().astype(np.float64)
        for got, ref in zip(g[:2], c[:2]):
            a, b = mass[flip, got[flip]], mass[flip, ref[flip]]
            np.testing.assert_allclose(
                a, b, rtol=1e-5, err_msg="top-two topics differ beyond a tie")
            gap = max(gap, float((np.abs(a - b) / np.abs(b)).max()))
    return flip, gap


def check_tiny(corpus, seed: int, out: str, label: str = "",
               **opts):
    """The small corpus trained on the card and on the CPU with the same
    options: equal clusters, eigenvalues within rtol 1e-4, models within
    rtol 1e-4, atol 1e-6, top-two topics equal up to ties (tie_flips),
    and edge topics within rtol 1e-4, atol 1e-6 of the CPU's edge
    construction from the card's top-two topics. Returns the card's and
    the CPU's trainer."""
    from isle_tpu_torch.topic_model import construct_edge_topics_v2

    tag = label.replace(" ", "_").replace("=", "_")
    gpu = train(corpus, TINY, seed, "cuda",
                os.path.join(out, f"tiny_cuda{tag}"), **opts)
    cpu = train(corpus, TINY, seed, "cpu",
                os.path.join(out, f"tiny_cpu{tag}"), **opts)
    assert np.array_equal(gpu.cluster_of_doc, cpu.cluster_of_doc), \
        f"tiny {label}: clusters differ between the card and the CPU"
    np.testing.assert_allclose(gpu.evalues, cpu.evalues, rtol=1e-4)
    np.testing.assert_allclose(gpu.model, cpu.model, rtol=1e-4, atol=1e-6)
    flips, gap = tie_flips(gpu, cpu)
    hp = cpu.config.hyper
    edge, pairs = construct_edge_topics_v2(
        *gpu.top_pairs, cpu.model, TINY["k"], TINY["edges"],
        min_docs=hp.edge_topic_min_docs,
        primary_ratio=hp.edge_topic_primary_ratio)
    assert np.array_equal(gpu.edge_pairs, pairs), f"tiny {label}: edge pairs"
    np.testing.assert_allclose(gpu.edge_model, edge, rtol=1e-4, atol=1e-6)
    print(f"tiny corpus {TINY}{' ' + label if label else ''}: card == CPU "
          f"(clusters equal, {len(gpu.original_cols)} docs in B, model max "
          f"abs diff {np.abs(gpu.model - cpu.model).max():.3e}, top-two "
          f"topics flipped on ties in {flips.size} docs, largest relative "
          f"mass gap {gap:.3e})")
    return gpu, cpu


def inferencer(model: np.ndarray, device: str, out: str):
    from isle_tpu_torch import GpuConfig, InferConfig, Inferencer

    V, k = model.shape
    return Inferencer(InferConfig(num_topics=k, vocab_size=V), model=model,
                      output_dir=out, quiet=True,
                      gpu=GpuConfig(device=device))


def check_tiny_infer(tr, corpus, out: str) -> None:
    """The small corpus inferred with its model on the card and on the
    CPU: equal convergence flags, weights and LLHs within rtol 1e-4, atol
    1e-6."""
    res = {dev: inferencer(tr.model, dev, os.path.join(out, f"infer_{dev}"))
           .infer_corpus(corpus) for dev in ("cuda", "cpu")}
    g, c = res["cuda"], res["cpu"]
    assert np.array_equal(g.converged, c.converged), \
        "tiny inference: convergence differs between the card and the CPU"
    for f in ("weights", "llh_per_doc", "llh_weighted"):
        np.testing.assert_allclose(getattr(g, f), getattr(c, f), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    print(f"tiny inference: card == CPU ({g.num_converged}/{corpus.num_docs} "
          f"converged, weights max abs diff "
          f"{np.abs(g.weights - c.weights).max():.3e})")


def doc_subset(corpus, docs: np.ndarray):
    """The Corpus of `docs` (ascending ids of `corpus`), renumbered from
    0, with their entries copied; avg_doc_sz stays the whole corpus's."""
    from isle_tpu_torch import Corpus

    lengths = np.diff(corpus.offsets)[docs]
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    idx = (np.repeat(corpus.offsets[docs] - offsets[:-1], lengths)
           + np.arange(offsets[-1]))
    return Corpus(vocab_size=corpus.vocab_size, num_docs=len(docs),
                  offsets=offsets, rows=corpus.rows[idx],
                  counts=corpus.counts[idx], vals=corpus.vals[idx],
                  avg_doc_sz=corpus.avg_doc_sz,
                  nz_docs=int((lengths > 0).sum()))


def mwu_sample_check(corpus, model: np.ndarray, weights, converged,
                     seed: int, top_n: int = 0) -> float:
    """A fixed sample of the docs of `corpus` (normalized to unit mass)
    through the plain MWU core in float64 on the CPU, against the card's
    weights: within atol 1e-4, the same convergence flags. With `top_n`
    the card's rows hold only their top_n weights (infer_corpus(top_n=...),
    the rest 0.0): those entries are held to the float64 weights at the
    same topics, and each must be among the float64 run's largest (no
    weight left out above a kept one by more than 1e-4). Returns the max
    abs difference."""
    from isle_tpu_torch import HyperParams
    from isle_tpu_torch.mwu import build_infer_batch, mwu_core

    hp = HyperParams()
    V, k = model.shape
    n = min(MWU_SAMPLE, corpus.num_docs)
    sample = np.sort(np.random.default_rng(seed).choice(
        corpus.num_docs, n, replace=False))
    batch = build_infer_batch(doc_subset(corpus, sample), model.sum(axis=1))
    Mw = torch.cat([torch.from_numpy(model).double(),
                    torch.zeros(1, k, dtype=torch.float64)])
    w64, c64 = [], []
    for lo in range(0, n, 256):
        wi = batch.word_idx[lo:lo + 256]
        L = max(int((wi < V).sum(axis=1).max()), 1)
        wt, ct, _ = mwu_core(Mw, torch.from_numpy(wi[:, :L]),
                             torch.from_numpy(batch.a[lo:lo + 256, :L])
                             .double(), hp.infer_iters_default,
                             hp.infer_Lf_default, hp.infer_max_guesses)
        w64.append(wt.numpy())
        c64.append(ct.numpy())
    w64, c64 = np.concatenate(w64), np.concatenate(c64)
    assert np.array_equal(c64, converged[sample]), \
        "inference: convergence flags differ from the float64 CPU run"
    w64 = np.where(c64[:, None], w64, 1.0 / k)
    got = weights[sample]
    if not top_n:
        err = float(np.abs(got - w64).max())
    else:
        kept = (got > 0) & c64[:, None]
        assert (kept.sum(axis=1) <= top_n).all()
        err = float(np.abs(got - w64)[kept].max(initial=0.0))
        low = np.where(kept, w64, np.inf).min(axis=1)
        left = np.where(kept | ~c64[:, None], -np.inf, w64).max(axis=1)
        assert (left <= low + 1e-4).all(), \
            "inference: a kept top weight is not among the float64 largest"
    assert err <= 1e-4, f"inference: max abs err {err} against float64"
    return err


def infer_full(tr, entries, shape: dict, seed: int, out: str,
               label: str = "inference", top_equal: bool = False,
               name: str = "infer_nyt") -> None:
    """Phase 8 (and Z7 on the bite corpus): infer the NYTimes docs with
    the trained model. `top_equal`: the top-5 run's kept weights are
    required equal to the full run's, else printed. Each run packs its
    batch on the card: one launch of each pack kernel, counted from zero
    just before it. Returns the pack kernels' launches over the runs."""
    from isle_tpu_torch import pack, segsum

    t0 = time.perf_counter()
    corpus = make_corpus(entries, shape, normalize_to_one=True)
    print(f"{label} corpus: {corpus.num_docs} docs normalized to unit "
          f"mass in {time.perf_counter() - t0:.1f} s (host)")
    runs = {}
    pack_launches = {PACK_KEPT: 0, PACK_FILL: 0}
    for top_n in (5, 0):
        inf = inferencer(tr.model, "cuda", os.path.join(out, name))
        assert inf.device.type == "cuda"
        torch.cuda.reset_peak_memory_stats()
        segsum.reset_launch_counts()
        pack.pack_kept_lengths.launches = pack.pack_fill.launches = 0
        t0 = time.perf_counter()
        res = inf.infer_corpus(corpus, top_n=top_n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = segsum.launch_counts()
        packs = {PACK_KEPT: pack.pack_kept_lengths.launches,
                 PACK_FILL: pack.pack_fill.launches}
        assert packs == {PACK_KEPT: 1, PACK_FILL: 1}, \
            f"{label}: the card pack launched {packs}"
        for kernel, n in packs.items():
            pack_launches[kernel] += n
        pack_s = dict((label, w) for label, w, _ in inf.timer.phases)[
            "pack inference batch"]
        runs[top_n] = res
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{label} top_n={top_n}: {wall:.3f} s wall "
              f"(the card pack {pack_s:.3f} s), converged "
              f"{res.num_converged}/{corpus.num_docs}, avg LLH per "
              f"converged doc {res.avg_llh_per_converged_doc:.6f}, avg LLH "
              f"per word {res.avg_llh_per_word:.6f}, peak device memory "
              f"{peak:.2f} GiB, kernel launches {launches}, pack kernel "
              f"launches {packs}")
    top, full = runs[5], runs[0]
    conv = full.converged
    assert np.array_equal(conv, top.converged), \
        "inference: the two runs converge on other docs"
    assert conv.mean() >= 0.9, f"inference: only {conv.mean():.3f} converged"
    sums = full.weights[conv].sum(axis=1, dtype=np.float64)
    assert np.all(np.abs(sums - 1.0) <= 1e-2), "inference: rows off 1"
    for r in (top, full):
        assert np.isfinite(r.llh_per_doc).all() and \
            np.isfinite(r.llh_weighted).all(), "inference: LLH not finite"
        assert np.isfinite(r.avg_llh_per_converged_doc) and \
            np.isfinite(r.avg_llh_per_word)
    # the top-5 run's kept weights against the same entries of the full run
    kept = (top.weights > 0) & conv[:, None]
    bit_equal = bool(np.array_equal(top.weights[kept], full.weights[kept]))
    assert bit_equal or not top_equal, \
        f"{label}: the top-5 run's weights differ from the full run's"
    err = mwu_sample_check(corpus, tr.model, full.weights, conv, seed)
    print(f"{label} checks: rows sum to 1 within "
          f"{np.abs(sums - 1.0).max():.2e}; top-5 run bit-equal to the full "
          f"run: {bit_equal}; {min(MWU_SAMPLE, shape['docs'])}-doc sample "
          f"vs float64 CPU max abs "
          f"err {err:.3e}")
    return pack_launches


def bound(nbytes: int, ops: int, rate: float = FP32_FLOPS) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    the operations over `rate` (by default the float32 rate)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def onehot_window(nc: int, sums: bool = False) -> dict:
    """The row window segsum_onehot's kernel reduces `nc` columns in (of
    counts, or with `sums` of float values): rows of ONEHOT_WINDOW_CELLS
    cells, column tiles per row."""
    cells = ONEHOT_WINDOW_CELLS["sums" if sums else "counts"]
    ct = min(nc, cells)
    return {"window_rows": cells // ct, "column_tiles": -(-nc // ct)}


def onehot_use(use, seg, col, val, S, nc, launches, whole=None,
               init=None, chunk=2048, library=None) -> dict:
    """segsum_onehot against its plain version and index_put_ (or
    `library`, another call of the same function), two launches
    bit-equal. `whole`: {label: fn} of the caller's function around the
    kernel and what it replaced, each timed too. `init`: the carry of a
    streamed use, read once and written once in the bound."""
    from isle_tpu_torch import segsum

    got = segsum.segsum_onehot(seg, col, val, S, nc, init=init, chunk=chunk)
    again = segsum.segsum_onehot(seg, col, val, S, nc, init=init,
                                 chunk=chunk)
    bit_equal = bool(torch.equal(got, again))
    assert bit_equal, f"{use}: two launches differ"
    del again
    if val is None:
        ref = segsum.segsum_onehot_plain(seg, col, None, S, nc, init=init)
        assert torch.equal(got, ref), f"{use}: counts differ"
        err = 0.0
    else:
        ref = segsum.segsum_onehot_plain(
            seg, col, val.double(), S, nc,
            init=None if init is None else init.double())
        err = float((got.double() - ref).abs().max())
        assert torch.allclose(got.double(), ref, rtol=1e-5, atol=0), \
            f"{use}: max abs err {err}"
    n = seg.numel()
    dtype = got.dtype
    # the library call on the entries the kernel counts, indexed outside
    # the timed window
    ok = (seg >= 0) & (seg <= S)
    if col is not None:
        ok &= (col >= 0) & (col < nc)
    si = seg[ok].long()
    ci = torch.zeros_like(si) if col is None else col[ok].long()
    vi = (torch.ones(si.numel(), dtype=dtype, device=seg.device)
          if val is None else val[ok])

    def index_put():
        start = (torch.zeros((S + 1, nc), dtype=dtype, device=seg.device)
                 if init is None else init.clone())
        return start.index_put_((si, ci), vi, accumulate=True)

    library = library or index_put
    lib_err = float((library().double().reshape(ref.shape)
                     - ref.double()).abs().max())
    # seg, col and val where given, read once; the carry read once where
    # there is one; the output written once
    per_entry = 4 + (col is not None) * 4 + (val is not None) * 4
    nbytes = n * per_entry + got.numel() * 4 * (1 + (init is not None))
    bound_ms, bound_by = bound(nbytes, n)
    return dict(
        use=use, n=n, shape=[S + 1, nc], launches=launches, max_abs_err=err,
        bit_equal=bit_equal, window=onehot_window(nc, val is not None),
        with_init=init is not None, slice_len=chunk,
        whole_ms={label: time_ms(fn) for label, fn in (whole or {}).items()},
        ms=time_ms(lambda: segsum.segsum_onehot(seg, col, val, S, nc,
                                                init=init, chunk=chunk)),
        plain_ms=time_ms(lambda: segsum.segsum_onehot_plain(
            seg, col, val, S, nc, init=init)),
        library_ms=time_ms(library), library_max_abs_err=lib_err,
        bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
    )


def gather_use(use, seg, idx, val, table, S, launches, init=None,
               chunk=2048, kernel="wide", tiles=None, beside=()) -> dict:
    """One of segsum_gather_rows's kernels (`kernel`: "wide", "narrow",
    or "tiled" over `tiles`, the (seg, idx, val, tile_starts) of the
    tile-ordered copy of the stream) against its plain version and
    torch.sparse.mm: each element within 1e-5 |B| |X| of the float64
    plain version, two launches bit-equal. `init`: the carry of a
    streamed use, read once and written once in the bound; `table` holds
    the rows the stream can index and no others, each counted once.
    `beside`: other kernels timed on the same inputs ("wide" for the
    narrow kernel's crossover; the tiled passes are also held within 1e-5
    |B| |X| of the untiled wide kernel and timed beside it)."""
    from isle_tpu_torch import segsum

    def launch(k):
        if k == "tiled":  # at the slice length the passes choose
            ts, ti, tv, starts = tiles
            return segsum.segsum_gather_rows_tiled(ts, ti, tv, table, S,
                                                   starts, init=init)
        return segsum.segsum_gather_rows(seg, idx, val, table, S, init=init,
                                         chunk=chunk, kernel=k)

    got = launch(kernel)
    again = launch(kernel)
    bit_equal = bool(torch.equal(got, again))
    assert bit_equal, f"{use}: two launches differ"
    del again
    ref = segsum.segsum_gather_rows_plain(
        seg, idx, val.double(), table.double(), S,
        init=None if init is None else init.double())
    scale = segsum.segsum_gather_rows_plain(
        seg, idx, val.double().abs(), table.double().abs(), S,
        init=None if init is None else init.double().abs())
    diff = (got.double() - ref).abs()
    err = float(diff.max())
    worst = float((diff / scale.clamp(min=1e-300)).max())
    assert bool((diff <= 1e-5 * scale).all()), \
        f"{use}: max abs err {err}, max err / (|B| |X|) {worst}"
    if kernel == "tiled":
        untiled = launch("wide").double()
        to_untiled = float((got.double() - untiled).abs().max())
        assert bool(((got.double() - untiled).abs() <= 1e-5 * scale).all()), \
            f"{use}: tiled against untiled max abs diff {to_untiled}"
        del untiled
    del scale, diff
    rows, W = table.shape
    n = seg.numel()
    # the library call: cuSPARSE SpMM on a CSR copy of the sorted stream
    # (made outside the timed window); the port never calls it
    crow = torch.zeros(S + 1, dtype=torch.int64, device=seg.device)
    crow[1:] = torch.cumsum(torch.bincount(seg.long(), minlength=S + 1)[:S],
                            0)
    csr = torch.sparse_csr_tensor(crow.int(), idx, val, size=(S, rows),
                                  check_invariants=False)

    def library():
        out = torch.sparse.mm(csr, table)
        return out if init is None else out + init[:S]

    lib_err = float((library().double() - ref[:S]).abs().max())
    del ref
    nbytes = (n * 12 + table.numel() * 4
              + got.numel() * 4 * (1 + (init is not None)))
    bound_ms, bound_by = bound(nbytes, 2 * n * W)
    row = dict(
        use=use, kernel=kernel, n=n, shape=[S + 1, W], table=[rows, W],
        launches=launches, max_abs_err=err, err_over_abs_bound=worst,
        bit_equal=bit_equal, with_init=init is not None, slice_len=chunk,
        ms=time_ms(lambda: launch(kernel)),
        plain_ms=time_ms(lambda: segsum.segsum_gather_rows_plain(
            seg, idx, val, table, S, init=init)),
        library_ms=time_ms(library), library_max_abs_err=lib_err,
        bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
    )
    if kernel == "tiled":
        row.update(tiles=len(segsum.tile_spans(tiles[3])),
                   slice_len=segsum.tiled_pass_chunk(tiles[3]),
                   max_abs_diff_to_untiled=to_untiled,
                   beside_ms={"untiled": time_ms(lambda: launch("wide"))})
    if beside:
        row.setdefault("beside_ms", {}).update(
            {k: time_ms(lambda k=k: launch(k)) for k in beside})
    return row


def lloyds_reps(tr) -> int:
    """Full-space Lloyd's iterations of the run, from its diagnostic log."""
    path = os.path.join(tr.run_dir, "diagnosticLog.txt")
    with open(path) as f:
        reps = [int(line.split("ran ")[1].split()[0]) for line in f
                if line.startswith("full lloyds ran ")]
    assert reps, f"no full-space Lloyd's line in {path}"
    return reps[-1]


def catchword_topics(tr, device="cuda") -> torch.Tensor:
    """(vocab,) int32 on `device`: each catchword's topic in run `tr`, -1
    for the other words."""
    cwt = torch.full((tr.corpus.vocab_size,), -1, dtype=torch.int32)
    for t, cw in enumerate(tr.catchwords):
        cwt[torch.as_tensor(cw, dtype=torch.long)] = t
    return cwt.to(device)


def onehot_streams(tr) -> tuple:
    """The main path's segsum_onehot uses of a trained run, as (use, seg,
    col, val, S, ncols, launches on the main path), and the thresholded
    matrix B: the ζ histogram, the r-th group counts and the doc-topic
    mass on A's streams, the doc norms (sparse.doc_l2sq) on B's."""
    from isle_tpu_torch import bmatrix, thresholds

    A = tr.A
    hp, k = tr.config.hyper, tr.config.num_topics
    V, D = A.vocab, A.num_docs
    for name, s in (("w_word", A.w_word), ("d_doc", A.d_doc)):
        assert bool(torch.all(s[1:] >= s[:-1])), f"{name} is not sorted"
    cluster = torch.as_tensor(tr.cluster_of_doc).to(A.device)
    cwt = catchword_topics(tr)
    F = thresholds.freq_bound(tr.corpus.avg_doc_sz)

    # B as the main path built it (no sampling: the same thresholds)
    zetas, _ = thresholds.compute_thresholds(
        A, tr.corpus.avg_doc_sz, tr.corpus.nz_docs, k, hp)
    B, cols = bmatrix.threshold_and_copy(A, zetas)
    assert np.array_equal(cols, tr.original_cols), "B differs from the run's"
    return (
        ("zeta histogram", A.w_word, thresholds.hist_cols(A.w_val, F), None,
         V, F + 1, 1),
        ("r-th group counts", A.w_word, cluster[A.w_doc], None, V, k, 1),
        ("doc-topic mass", A.d_doc, cwt[A.d_word], A.d_val, D, k, 1),
        # sparse.doc_l2sq: Frob(B) and the full-space Lloyd's
        ("doc norms of B", B.d_doc, None, B.d_val * B.d_val, B.num_docs, 1,
         2),
    ), B


def compare_kernels(tr, launches: dict, seed: int) -> dict:
    """Each kernel against its plain version, at the main path's shapes on
    its own streams: A's for the three onehot uses and the model SpMM,
    the thresholded B's for the doc norms and the SpMM of the eigensolver
    and of Lloyd's."""
    from isle_tpu_torch import sparse, topic_model

    A = tr.A
    hp, k = tr.config.hyper, tr.config.num_topics
    V, D = A.vocab, A.num_docs
    dev = A.device
    cluster = torch.as_tensor(tr.cluster_of_doc).to(dev)
    cwt = catchword_topics(tr)
    mass = topic_model.doc_topic_mass(A, cwt, k)
    has_cw = torch.bincount(cwt[cwt >= 0].long(), minlength=k) > 0
    thr = topic_model.model_thresholds(mass, has_cw,
                                       hp.model_rank_threshold(D, k))
    Wc = topic_model._contribution_weights(mass, thr, cluster)
    del mass
    streams, B = onehot_streams(tr)

    def index_add_l2sq():  # sparse.doc_l2sq before it ran on the kernel
        return torch.zeros(B.num_docs, device=dev).index_add_(
            0, B.d_doc, B.d_val * B.d_val)

    whole = {"doc norms of B": {
        "sparse.doc_l2sq": lambda: sparse.doc_l2sq(B),
        "index_add_ (before)": index_add_l2sq}}
    uses = {ONEHOT: [], GATHER: [], NARROW: [], TILED: []}
    for use, seg, col, val, S, nc, n_launch in streams:
        uses["segsum_onehot"].append(
            onehot_use(use, seg, col, val, S, nc, n_launch, whole.get(use)))
    del streams
    calls, reps = tr.op_counter.calls, lloyds_reps(tr)
    blk = hp.block_ks_block_size
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((V, blk), generator=g).to(dev)  # a Krylov block
    Y = sparse.bt_x(B, X)
    centers = torch.as_tensor(tr.centers).T.contiguous().to(dev)
    assign = torch.as_tensor(tr.cluster_of_doc[tr.original_cols]).long().to(
        dev)
    onehot = torch.nn.functional.one_hot(assign, k).to(torch.float32)
    d_stream = (B.d_doc, B.d_word, B.d_val)
    w_stream = (B.w_word, B.w_doc, B.w_val)
    # the trainer gives B its doc tiles (sparse.with_doc_tiles): the word
    # stream's products take the tiled passes where the dispatch says so,
    # each listed under the wide kernel and the tiled mode with the
    # launches of the mode that ran it
    BT = sparse.with_doc_tiles(B)
    t_stream = (BT.t_word, BT.t_doc, BT.t_val, BT.tile_starts)
    for use, stream, table, S, n_launch in (
        ("model SpMM B W", (A.w_word, A.w_doc, A.w_val), Wc, V, 1),
        ("eigensolver B^T X", d_stream, X, B.num_docs, calls),
        ("eigensolver B Y", w_stream, Y, V, calls),
        ("Lloyd's B^T C (+ projection)", d_stream, centers, B.num_docs,
         reps + 1),
        ("Lloyd's B onehot", w_stream, onehot, V, reps),
    ):
        tiled = stream is w_stream and tiles_taken(BT, table)
        uses[GATHER].append(
            gather_use(use, *stream, table, S, 0 if tiled else n_launch))
        if stream is w_stream:
            uses[TILED].append(gather_use(
                use + ", tiled", *stream, table, S, n_launch if tiled else 0,
                kernel="tiled", tiles=t_stream))
    del BT, t_stream
    return uses


def gather_calls(uses: dict, key: str = "launches") -> int:
    """The segsum_gather_rows calls the uses account for: each call is
    one use's launch of the wide kernel, the narrow one or the tiled
    passes."""
    return sum(u.get(key, 0) for name in (GATHER, NARROW, TILED)
               for u in uses.get(name, []))


def run_mass(tr) -> torch.Tensor:
    """The doc-topic mass of a run (segsum_onehot on the card), from its
    catchwords."""
    from isle_tpu_torch.topic_model import doc_topic_mass

    return doc_topic_mass(tr.A, catchword_topics(tr), len(tr.catchwords))


def cumsum_probe(n: int, launches: int = 200) -> None:
    """How reproducible torch.cumsum is on the card: distinct results of
    `launches` launches on one vector of n floats (beside torch.sum and a
    float32 matmul reduced over n, which the path still runs there)."""
    g = torch.Generator().manual_seed(0)
    x = ((torch.rand(n, generator=g) ** 4) * 50).cuda()
    a = torch.randn((100, n), generator=g).cuda()

    def distinct(fn):
        seen = []
        for _ in range(launches):
            out = fn()
            if not any(torch.equal(out, s) for s in seen):
                seen.append(out)
        return len(seen)

    print(f"reproducibility on the card, {launches} launches on one input "
          f"of {n} floats: torch.cumsum {distinct(lambda: torch.cumsum(x, 0))}"
          f" distinct results, torch.sum {distinct(lambda: torch.sum(x))}, "
          f"float32 matmul (100 x {n}) @ ({n} x 100) "
          f"{distinct(lambda: a @ a.T)}")


def train_again(corpus, shape, seed, out, first, head_bytes=0) -> float:
    """One more training run of the same corpus and seed: its wall, and
    its results required equal to the first run's, bit for bit. Returns
    the wall."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = train(corpus, shape, seed, "cuda", out, head_bytes=head_bytes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_cw = [sum(len(c) for c in t.catchwords) for t in (first, tr)]
    n_edge = [t.edge_model.shape[1] for t in (first, tr)]
    same = {
        "clusters": np.array_equal(tr.cluster_of_doc, first.cluster_of_doc),
        "catchwords": all(np.array_equal(a, b) for a, b in
                          zip(tr.catchwords, first.catchwords)),
        "doc-topic mass": bool(torch.equal(run_mass(tr), run_mass(first))),
        "eigenvalues": np.array_equal(tr.evalues, first.evalues),
        "centers": np.array_equal(tr.centers, first.centers),
        "model": np.array_equal(tr.model, first.model),
        "edge model": np.array_equal(tr.edge_model, first.edge_model),
    }
    layout = "COO" if head_bytes == 0 else "hybrid"
    print(f"repeated training run ({layout}): {wall:.2f} s wall; catchwords "
          f"{n_cw[1]} "
          f"(first {n_cw[0]}), edge topics {n_edge[1]} (first {n_edge[0]}); "
          + ", ".join(f"{name} equal: {ok}" for name, ok in same.items()))
    tr.A = None
    differ = [name for name, ok in same.items() if not ok]
    assert not differ, \
        f"a repeated run of one tree differs from the first in {differ}"
    return wall


def print_uses(uses: dict, path: str) -> None:
    for name, rows in uses.items():
        for u in rows:
            print(f"  {name} [{u['use']}] n={u['n']} out={u['shape']}: "
                  f"kernel {u['ms']:.3f} ms, plain {u['plain_ms']:.3f} ms, "
                  f"library {u['library_ms']:.3f} ms, bound "
                  f"{u['bound_ms']:.3f} ms "
                  f"({u['bound_by']}: {u['bound_bytes']} B), launches on "
                  f"the {path} {u['launches']}, max abs err "
                  f"{u['max_abs_err']:.3e}, bit-equal across two launches "
                  f"{u['bit_equal']}"
                  + (f", window {u['window']['window_rows']} row(s) x "
                     f"{u['shape'][1]} columns in "
                     f"{u['window']['column_tiles']} column tile(s)"
                     if "window" in u else "")
                  + "".join(f"; {label} {ms:.3f} ms"
                            for label, ms in u.get("whole_ms", {}).items())
                  + (f"; {u['kernel']} kernel" if "kernel" in u else "")
                  + (f", {u['tiles']} tiles, max abs diff to the untiled "
                     f"kernel {u['max_abs_diff_to_untiled']:.3e}"
                     if "tiles" in u else "")
                  + "".join(f"; {label} kernel {ms:.3f} ms"
                            for label, ms in u.get("beside_ms", {}).items()))


def run_dir_arrays(tr, stage: str) -> dict:
    with np.load(os.path.join(tr.run_dir, f"ckpt_{stage}.npz")) as z:
        return dict(z)


def streamed_trainer(corpus, shape, seed, out, mesh=None, head_bytes=0,
                     resident_bytes=0, hbm_bytes=0,
                     chunk_entries=STREAM_CHUNK_ENTRIES, **cfg_kw):
    """A StreamedTrainer at `chunk_entries`. `resident_bytes` is
    GpuConfig.resident_corpus_bytes: 0, the wire loader, for S1-S5 and
    H3, None for GpuConfig's default (phases R and P); `hbm_bytes` is
    GpuConfig.hbm_bytes."""
    from isle_tpu_torch import TrainConfig
    from isle_tpu_torch.streaming import StreamedTrainer

    cfg = TrainConfig(num_topics=shape["k"], seed=seed,
                      compute_edge_topics=True,
                      max_edge_topics=shape["edges"], **cfg_kw)
    gpu_kw = dict(hbm_bytes=hbm_bytes)
    if resident_bytes is not None:
        gpu_kw["resident_corpus_bytes"] = resident_bytes
    st = StreamedTrainer(cfg, output_dir=out, quiet=True,
                         chunk_entries=chunk_entries,
                         gpu=gpu_config("cuda", head_bytes, **gpu_kw),
                         mesh=mesh)
    st.load_corpus(corpus)
    return st


def stage_launches(tr) -> dict:
    """{stage: {kernel: launches within the stage}} of a run whose launch
    counts were set to 0 just before it."""
    per, last = {}, {}
    for label, now in tr.stage_launches:
        per[label] = {name: now[name] - last.get(name, 0) for name in now}
        last = now
    return per


def check_streamed_launches(per: dict, chunks: int, label: str) -> None:
    """Every streamed pass of a run launched its kernel exactly once a
    chunk (the catchword pass: one launch for the group counts), by the
    counts read at the end of each stage (a sharded streamed stage is
    held to the streamed stage of its label)."""
    want = {
        "streamed thresholds": (chunks, 0),  # the ζ histogram
        "streamed doc sampling": (chunks, 0),  # the doc weights
        "streamed B construction": (0, 0),
        "streamed catchwords": (1, 0),  # the r-th group counts
        # the doc-topic mass and the model accumulation
        "streamed topic model": (chunks, chunks),
    }
    for stage, counts in per.items():
        need = want.get(stage.replace(" (sharded)", ""))
        if need is not None:
            assert (counts[ONEHOT], counts[GATHER]) == need, \
                f"{label}: stage {stage!r} launched {counts}, expected " \
                f"(onehot, gather) = {need} with {chunks} chunks"
    print(f"{label}: launches by stage (segsum_onehot, segsum_gather_rows): "
          + "; ".join(f"{stage} ({c[ONEHOT]}, {c[GATHER]})"
                      for stage, c in per.items()))


def run_streamed(st) -> tuple:
    """train() + train_edge_topics() of a streamed trainer with the launch
    counts set to 0 just before. Returns (wall seconds, (peak device GiB,
    GiB held on the card before the run), launch counts, launches by
    stage)."""
    from isle_tpu_torch import segsum

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    segsum.reset_launch_counts()
    t0 = time.perf_counter()
    st.train()
    st.train_edge_topics()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (wall, (torch.cuda.max_memory_allocated() / 2**30, held),
            segsum.launch_counts(), stage_launches(st))


def print_streamed_run(label, st, wall, peak, launches) -> None:
    loader = st.loader
    wait_s = loader.copy_wait_ms() / 1e3
    copied = loader.bytes_copied
    st.run_bytes_copied = copied  # before any later pass over the loader
    print(f"{label}: train + edge topics {wall:.2f} s wall in "
          f"{len(loader.ranges)} chunks of at most {loader.chunk_entries} "
          f"entries, peak device memory {peak[0]:.2f} GiB ({peak[1]:.2f} "
          f"GiB of it held before the run), kernel launches "
          f"{launches}; {copied} bytes copied to the card "
          f"({copied / (8 * loader.corpus.nnz):.2f} passes over the "
          f"corpus's word ids and values); the stream waited {wait_s:.4f} s "
          f"for copies ({wait_s / wall:.2%} of the wall), the host "
          f"{loader.host_wait_seconds:.4f} s for a free staging buffer "
          f"({loader.host_wait_seconds / wall:.2%})"
          + (f"; resident slabs ({loader.slab_bytes} bytes by isle_tpu's "
             f"rule, " + ("values float32" if loader.count_dtype is None
                          else f"counts {np.dtype(loader.count_dtype).name}")
             + f") "
             f"filled {loader.fill_count} time(s) in "
             f"{loader.fill_seconds:.4f} s"
             if hasattr(loader, "fill_count") else ""))
    for stage, w, _ in st.timer.phases:
        print(f"  {label} stage {stage}: {w:.3f} s")


def assert_same_b(B, IB) -> None:
    assert B.num_docs == IB.num_docs
    for f in B_FIELDS:
        assert torch.equal(getattr(B, f), getattr(IB, f)), f"streamed B: {f}"


def streamed_phase(corpus, shape, seed, out, tr):
    """Phase S1. Returns the streamed trainer, its launch counts, its
    launches by stage and B on the card."""
    from isle_tpu_torch import bmatrix, streaming
    from isle_tpu_torch.sparse import DocSparse

    st = streamed_trainer(corpus, shape, seed, os.path.join(out, "nyt_s"))
    wall, peak, launches, per = run_streamed(st)
    loader = st.loader
    print_streamed_run("streamed path", st, wall, peak, launches)
    check_streamed_launches(per, len(loader.ranges), "streamed path")
    assert "streamed doc sampling" not in per
    assert per["eigen solve (B B^T)"][GATHER] >= 2 * st.op_counter.calls

    ours, ref = run_dir_arrays(st, "svd"), run_dir_arrays(tr, "svd")
    assert np.array_equal(ours["zetas"], ref["zetas"]), "streamed zetas"
    assert np.array_equal(ours["original_cols"], ref["original_cols"])
    np.testing.assert_allclose(ours["evalues"], ref["evalues"], rtol=1e-4)
    sums = st.model.sum(axis=0, dtype=np.float64)
    zero = ~st.model.any(axis=0)
    assert np.all(zero | (np.abs(sums - 1.0) <= 1e-5)), sums
    assert np.isfinite(st.model).all() and np.isfinite(st.edge_model).all()
    # B: the in-core stage on the whole corpus against the streamed one
    A = DocSparse.from_corpus(corpus, "cuda")
    z = torch.from_numpy(ref["zetas"]).cuda()
    IB, in_cols = bmatrix.threshold_and_copy(A, z)
    B, cols = streaming.streamed_build_b(corpus, z, None, loader)
    assert np.array_equal(cols, in_cols)
    assert_same_b(B, IB)
    del A, IB
    n_cw = sum(len(c) for c in st.catchwords)
    print(f"streamed checks: zetas, original_cols and B ({B.nnz} nnz, "
          f"{B.num_docs} docs) equal the in-core stages'; eigenvalues max "
          f"rel diff {np.abs(ours['evalues'] / ref['evalues'] - 1).max():.2e}"
          f"; {n_cw} catchwords, {st.edge_model.shape[1]} edge topics, "
          f"{int(zero.sum())} empty topics; clusters equal the in-core "
          f"run's: {np.array_equal(st.cluster_of_doc, tr.cluster_of_doc)}")
    return st, launches, per, B


def streamed_resume_phase(corpus, shape, seed, out, tr, loader) -> dict:
    """Phase S1's second part: the finish passes, from the in-core run's
    svd and kmeans checkpoints, against the in-core run's results.
    Returns the run's launch counts."""
    from isle_tpu_torch import segsum, streaming

    st = streamed_trainer(corpus, shape, seed, os.path.join(out, "nyt_r"))
    for stage in ("svd", "kmeans", "model"):
        path = os.path.join(st.run_dir, f"ckpt_{stage}.npz")
        if os.path.exists(path):
            os.remove(path)
        if stage != "model":
            shutil.copy(os.path.join(tr.run_dir, f"ckpt_{stage}.npz"), path)
    torch.cuda.synchronize()
    segsum.reset_launch_counts()
    t0 = time.perf_counter()
    st.train(resume=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segsum.launch_counts()
    per = stage_launches(st)
    assert set(per) == {"streamed catchwords", "streamed topic model"}, per
    check_streamed_launches(per, len(st.loader.ranges), "streamed resume")
    assert np.array_equal(st.cluster_of_doc, tr.cluster_of_doc)
    for t, (a, b) in enumerate(zip(st.catchwords, tr.catchwords)):
        assert np.array_equal(a, b), f"resumed run: catchwords of topic {t}"
    g, c = st.top_pairs, tr.top_pairs
    assert np.array_equal(g[2], c[2]), "resumed run: top-two valid flags"
    flip = np.flatnonzero((g[0] != c[0]) | (g[1] != c[1]))
    if flip.size:  # each must be a tie of the doc's two masses
        mass = streaming.streamed_doc_topic_mass(
            corpus, catchword_topics(st), shape["k"],
            loader).cpu().numpy().astype(np.float64)
        for got, ref in zip(g[:2], c[:2]):
            np.testing.assert_allclose(
                mass[flip, got[flip]], mass[flip, ref[flip]], rtol=1e-5,
                err_msg="resumed run: top-two topics differ beyond a tie")
    np.testing.assert_allclose(st.model, tr.model, rtol=1e-4, atol=1e-6)
    print(f"streamed resume from the in-core run's svd + kmeans "
          f"checkpoints: {wall:.2f} s wall; catchwords equal, top-two "
          f"topics equal but {flip.size} docs that flip on a tie, model max "
          f"abs diff {np.abs(st.model - tr.model).max():.3e}")
    return launches


def streamed_sampling_phase(corpus, shape, seed, out, tr,
                            name: str = "nyt_ss", label: str = "streamed path",
                            resident_bytes=0) -> tuple:
    """Phase S1's third part (and Z3's sampled pair on the bite corpus): a
    streamed run with document sampling, written under `name`, printed as
    `label`, on the loader `resident_bytes` chooses (streamed_trainer),
    and its selection and B against the in-core stage's with the same
    draws (the in-core run `tr`'s ζ). Returns (launch counts, launches by
    stage, the trainer)."""
    from isle_tpu_torch import bmatrix, streaming
    from isle_tpu_torch.rng import Draws
    from isle_tpu_torch.sparse import DocSparse

    rate, D = STREAM_SAMPLE_RATE, shape["docs"]
    st = streamed_trainer(corpus, shape, seed, os.path.join(out, name),
                          resident_bytes=resident_bytes, sample_docs=True,
                          sample_rate=rate)
    wall, peak, launches, per = run_streamed(st)
    loader = st.loader
    print_streamed_run(f"{label}, sampled at rate {rate}", st, wall, peak,
                       launches)
    check_streamed_launches(per, len(loader.ranges),
                            label.replace(" path", "") + ", sampled")
    assert "streamed doc sampling" in per
    sums = st.model.sum(axis=0, dtype=np.float64)
    zero = ~st.model.any(axis=0)
    assert np.all(zero | (np.abs(sums - 1.0) <= 1e-5)), sums
    assert np.isfinite(st.model).all() and np.isfinite(st.edge_model).all()
    ours, ref = run_dir_arrays(st, "svd"), run_dir_arrays(tr, "svd")
    assert np.array_equal(ours["zetas"], ref["zetas"]), "sampled run: zetas"
    cols = ours["original_cols"]

    # the in-core stage on the whole corpus with the same uniforms
    A = DocSparse.from_corpus(corpus, "cuda")
    z = torch.from_numpy(ref["zetas"]).cuda()
    u = Draws(seed).doc_sample_uniforms(D)
    IB, in_cols = bmatrix.threshold_and_copy(A, z, sample_rate=rate,
                                             uniforms=u)
    w_in = bmatrix.doc_weights(A, torch.floor(A.d_val + 0.5) >= z[A.d_word],
                               z)
    del A
    w_st = streaming.streamed_doc_weights(corpus, z, loader)
    assert torch.allclose(w_st, w_in, rtol=1e-5, atol=0), "doc weights"
    flips = np.setxor1d(cols, in_cols)
    if flips.size:  # only docs whose dice tie the pivot within rounding
        dice = bmatrix.doc_dice(w_in, u)
        pivot = torch.sort(dice, descending=True).values[
            min(int(rate * D), D - 1)]
        gap = (dice[torch.from_numpy(flips).long().cuda()] - pivot).abs()
        assert bool((gap <= 2e-7).all()), \
            f"sampled run: {flips.size} docs differ beyond a tie at the pivot"
    else:
        sel = torch.zeros(D, dtype=torch.bool, device="cuda")
        sel[torch.from_numpy(cols).long().cuda()] = True
        B, b_cols = streaming.streamed_build_b(corpus, z, sel, loader)
        assert np.array_equal(b_cols, in_cols)
        assert_same_b(B, IB)
    print(f"{label.replace(' path', '')} sampling checks: zetas equal the "
          f"in-core run's; "
          f"{len(cols)} of {D} docs kept; doc weights max rel diff to the "
          f"in-core stage's "
          f"{float(((w_st - w_in).abs() / w_in.clamp(min=1e-30)).max()):.2e}"
          f"; docs that flip on a tie at the pivot: {flips.size}"
          + ("" if flips.size else "; B equals the in-core stage's")
          + f"; {sum(len(c) for c in st.catchwords)} catchwords, "
          f"{st.edge_model.shape[1]} edge topics")
    return launches, per, st


# the sharded streamed trainer's stage labels beside S1's
SHARDED_STREAMED_STAGES = {
    "streamed thresholds (sharded)": "streamed thresholds",
    "streamed B construction (sharded)": "streamed B construction",
    "eigen solve (B B^T, sharded)": "eigen solve (B B^T)",
    "k-means (sharded)": "k-means",
    "streamed catchwords (sharded)": "streamed catchwords",
    "streamed topic model (sharded)": "streamed topic model",
}


def sharded_streamed_phase(corpus, shape, seed, out, st, B, mesh,
                           s_per) -> dict:
    """Phase S5: StreamedTrainer over the mesh against S1's streamed run
    `st` (B: S1's B on the card, s_per: its launches by stage). Returns
    the run's launch counts and its trainer."""
    from isle_tpu_torch.streaming_sharded import sharded_streamed_build_b

    ss = streamed_trainer(corpus, shape, seed, os.path.join(out, "nyt_ms"),
                          mesh=mesh)
    calls0, sec0 = mesh.collective_calls, mesh.collective_seconds()
    with no_library_spmm():
        wall, peak, launches, per = run_streamed(ss)
    coll_s = mesh.collective_seconds() - sec0
    loader = ss.loader
    label = f"sharded streamed path, world size {mesh.world}"
    print_streamed_run(label, ss, wall, peak, launches)
    print(f"  {label}: {mesh.collective_calls - calls0} collectives, "
          f"{coll_s:.4f} s inside them ({coll_s / wall:.2%} of the wall); "
          f"{card_line()}")
    assert ss.mesh is mesh and loader.doc_range == (0, shape["docs"])
    check_streamed_launches(per, len(loader.ranges), label)
    assert set(per) == set(SHARDED_STREAMED_STAGES), per
    for stage, counts in per.items():
        want = s_per[SHARDED_STREAMED_STAGES[stage]]
        assert counts == want, \
            f"sharded streamed stage {stage!r} launched {counts}, S1 {want}"

    ours, ref = run_dir_arrays(ss, "svd"), run_dir_arrays(st, "svd")
    assert np.array_equal(ours["zetas"], ref["zetas"]), "sharded zetas"
    assert np.array_equal(ours["original_cols"], ref["original_cols"])
    assert np.array_equal(ss.cluster_of_doc, st.cluster_of_doc), \
        "sharded streamed clusters differ from S1's"
    for t, (a, b) in enumerate(zip(ss.catchwords, st.catchwords)):
        assert np.array_equal(a, b), f"sharded streamed: catchwords of {t}"
    for a, b in zip(ss.top_pairs, st.top_pairs):
        assert np.array_equal(a, b), "sharded streamed: top-two topics"
    np.testing.assert_allclose(ss.model, st.model, rtol=0, atol=1e-6)
    assert np.array_equal(ss.edge_pairs, st.edge_pairs)
    np.testing.assert_allclose(ss.edge_model, st.edge_model, rtol=0,
                               atol=1e-6)
    # the rank's B, rebuilt by the stage the run took, against S1's
    z = torch.from_numpy(ref["zetas"]).cuda()
    SB, cols = sharded_streamed_build_b(corpus, z, None, loader, mesh)
    assert np.array_equal(cols, ref["original_cols"])
    assert SB.doc_counts == (B.num_docs,) and SB.nnz == B.nnz
    assert_same_b(SB.local, B)
    del SB
    print(f"sharded streamed checks: zetas, original_cols, B ({B.nnz} nnz), "
          "clusters, catchwords, top-two topics and edge pairs equal S1's; "
          f"model max abs diff {np.abs(ss.model - st.model).max():.3e} "
          f"(bit-equal: {np.array_equal(ss.model, st.model)}), edge model "
          f"bit-equal: {np.array_equal(ss.edge_model, st.edge_model)}; no "
          "torch.sparse call; launches by stage equal S1's")

    # the two steps the single-device stages do otherwise, on the run's
    # inputs, timed beside them: the rank selection of the model
    # thresholds (31 counting steps against a sort of the mass) and the
    # word shard of the clustered entries (an exchange against a sort)
    from isle_tpu_torch import streaming, topic_model
    from isle_tpu_torch.streaming_sharded import \
        sharded_model_thresholds, sharded_streamed_filter_clustered

    k, D = shape["k"], shape["docs"]
    cwt = catchword_topics(ss)
    mass = streaming.streamed_doc_topic_mass(corpus, cwt, k, loader)
    has_cw = topic_model.has_catchwords(cwt, k)
    r = ss.config.hyper.model_rank_threshold(D, k)
    thr = sharded_model_thresholds(mass, has_cw, r, D, mesh)
    assert torch.equal(thr, topic_model.model_thresholds(mass, has_cw, r))
    select_ms = time_ms(
        lambda: sharded_model_thresholds(mass, has_cw, r, D, mesh))
    sort_ms = time_ms(lambda: topic_model.model_thresholds(mass, has_cw, r))
    del mass
    cluster = torch.from_numpy(ss.cluster_of_doc).cuda()
    exchange_ms = time_ms(lambda: sharded_streamed_filter_clustered(
        corpus, cluster, loader, mesh))
    single_ms = time_ms(lambda: streaming.streamed_filter_clustered(
        corpus, cluster, loader))
    print(f"  rank selection of the model thresholds ({r}-th largest of "
          f"{D} x {k}): {select_ms:.3f} ms, equal to model_thresholds' "
          f"sort, {sort_ms:.3f} ms; clustered entries to their word's rank "
          f"({len(loader.ranges)}-chunk pass): {exchange_ms:.3f} ms, the "
          f"single-device "
          f"filter {single_ms:.3f} ms")
    return launches, ss


def middle_chunk(tr, corpus, loader) -> SimpleNamespace:
    """The loader's middle chunk as the streamed stages hand it to the
    kernels, from run `tr`'s ζ, catchwords and clusters: the doc-ordered
    chunk (w, v, d, docs [lo, hi)), its word-sorted streams for the
    histogram (hs, hr) and the model accumulation (ms, md on local doc
    ids, mv; table: the chunk's rows of the contribution weights), the
    two carries as they stand before it (hist, model), and the slice
    length of the word-keyed sums."""
    from isle_tpu_torch import segsum, streaming, thresholds, topic_model

    hp, k = tr.config.hyper, tr.config.num_topics
    V, D = corpus.vocab_size, corpus.num_docs
    F = thresholds.freq_bound(corpus.avg_doc_sz)
    dev = loader.device
    mid = len(loader.ranges) // 2
    cwt = catchword_topics(tr, dev)
    cluster = torch.from_numpy(tr.cluster_of_doc).to(dev)
    zetas = torch.from_numpy(run_dir_arrays(tr, "svd")["zetas"]).to(dev)
    mass = streaming.streamed_doc_topic_mass(corpus, cwt, k, loader)
    thr = topic_model.model_thresholds(
        mass, topic_model.has_catchwords(cwt, k),
        hp.model_rank_threshold(D, k))
    Wc = topic_model._contribution_weights(mass, thr, cluster)
    del mass
    hist = torch.zeros((V + 1, F + 1), dtype=torch.int32, device=dev)
    model = torch.zeros((V + 1, k), dtype=torch.float32, device=dev)
    for i, (lo, hi, w, v, d) in enumerate(loader.chunks()):
        if i == mid:
            w, v, d = w.clone(), v.clone(), d.clone()
            break
        ws, rs = streaming._sort_by_word(w, thresholds.hist_cols(v, F))
        hist = segsum.segsum_onehot(ws, rs, None, V, F + 1, init=hist)
        ws, ds, vs = streaming._sort_by_word(w, d - lo, v)
        model = segsum.segsum_gather_rows(ws, ds, vs, Wc[lo:hi], V,
                                          init=model)
    assert bool(hist.any()) and bool(model.any())
    hs, hr = streaming._sort_by_word(w, thresholds.hist_cols(v, F))
    ms, md, mv = streaming._sort_by_word(w, d - lo, v)
    for name, stream in (("hist", hs), ("model", ms), ("docs", d)):
        assert bool(torch.all(stream[1:] >= stream[:-1])), f"{name} unsorted"
    return SimpleNamespace(
        index=mid, lo=lo, hi=hi, w=w, v=v, d=d, F=F, k=k, V=V, cwt=cwt,
        zetas=zetas, hist=hist, model=model, hs=hs, hr=hr, ms=ms, md=md,
        mv=mv, table=Wc[lo:hi],
        word_slice=streaming.word_slice_len(w.numel(), V, tr.gpu.seg_chunk))


def streamed_uses(st, corpus, launched: dict, label: str = "") -> dict:
    """Phase S2 (and P4): both kernels' streamed uses on a middle chunk.
    `launched`: the launches of each use as read from the streamed runs
    (S1's); `label` goes before each use's name."""
    from isle_tpu_torch import streaming, thresholds

    loader = st.loader
    c = middle_chunk(st, corpus, loader)
    w, v, F, k, V = c.w, c.v, c.F, c.k, c.V
    n, rows = w.numel(), c.hi - c.lo
    sort_ms = {
        "sort by word, 1 payload (histogram)": time_ms(
            lambda: streaming._sort_by_word(w, thresholds.hist_cols(v, F))),
        "sort by word, 2 payloads (model)": time_ms(
            lambda: streaming._sort_by_word(w, c.d - c.lo, v)),
    }
    local = c.d - c.lo
    z = c.zetas[w]
    wcol = torch.where(torch.floor(v + 0.5) >= z, 0, -1).to(torch.int32)
    mass_init = torch.rand((rows + 1, k), device=loader.device)
    uses = {
        ONEHOT: [
            onehot_use("streamed zeta histogram, chunk with init", c.hs, c.hr,
                       None, V, F + 1, launched["histogram"], init=c.hist,
                       chunk=c.word_slice),
            onehot_use("streamed doc-topic mass, chunk's local docs", local,
                       c.cwt[w], v, rows, k, launched["mass"]),
            # no streamed stage passes the mass an init: checked, not driven
            onehot_use("streamed doc-topic mass, local docs with init",
                       local, c.cwt[w], v, rows, k, 0, init=mass_init),
            onehot_use("streamed sampling weights, chunk's local docs",
                       local, wcol, z, rows, 1, launched["weights"]),
        ],
        GATHER: [
            gather_use("streamed model accumulation, chunk with init", c.ms,
                       c.md, c.mv, c.table, V, launched["model"],
                       init=c.model, chunk=c.word_slice),
        ],
    }
    for rows_ in uses.values():
        for u in rows_:
            u["use"] = label + u["use"]
    print(f"{label}streamed uses on chunk {c.index} of {len(loader.ranges)} "
          f"(docs [{c.lo}, {c.hi}), {n} entries; the word-keyed sums in "
          f"slices of {c.word_slice} entries, streaming.word_slice_len): "
          + "; ".join(f"{what} {ms_:.3f} ms" for what, ms_ in sort_ms.items()))
    print_uses(uses, "streamed paths")
    return uses


@contextlib.contextmanager
def dispatch_before_narrow_and_tiles():
    """segsum's dispatch as it stood before the narrow kernel and the
    tiled passes (the wide kernel at every width, no tiles), so that one
    run times the Lanczos solve and the hybrid training both ways."""
    from isle_tpu_torch import segsum

    shipped = segsum.gather_path
    segsum.gather_path = lambda width, table_bytes, tile_rows=0: "wide"
    try:
        yield
    finally:
        segsum.gather_path = shipped


def lanczos_solve(B, tr, seed: int, chunk: int) -> tuple:
    """linalg.lanczos on B B^T at the trainer's tolerance and cap on
    restarts, launch counts set to 0 just before and read just after.
    Returns (the result, the wall, the launch counts)."""
    from isle_tpu_torch import linalg, segsum, sparse
    from isle_tpu_torch.rng import Draws

    hp = tr.config.hyper
    torch.cuda.synchronize()
    segsum.reset_launch_counts()
    t0 = time.perf_counter()
    res = linalg.lanczos(lambda X: sparse.gram_x(B, X, chunk), B.vocab,
                         tr.config.num_topics, Draws(seed), B.device,
                         tol=hp.block_ks_tolerance,
                         max_restarts=hp.block_ks_max_iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segsum.launch_counts()
    assert launches[GATHER] == 2 * res.op_calls, launches
    assert res.nconv == tr.config.num_topics, \
        f"lanczos converged {res.nconv} in {res.restarts} restarts"
    np.testing.assert_allclose(res.evals, np.asarray(tr.evalues), rtol=1e-3)
    return res, wall, launches


def lanczos_phase(B, tr, seed: int, chunk: int) -> tuple:
    """Phase S3 at the NYTimes shape: linalg.lanczos on B B^T, all k
    eigenvalues with the trainer's tolerance and cap on restarts, against
    the main path's block_ks eigenvalues, with the shipped dispatch (the
    width-1 matvecs on the narrow kernel) and then with the wide kernel
    at width 1, as before it. Then both kernels at widths 1 to 16 on B's
    two streams: the crossover that NARROW_MAX_WIDTH is set from. Returns
    ({kernel: the uses}, the launch counts of the shipped solve)."""
    from isle_tpu_torch import segsum, sparse

    V, D, nev = B.vocab, B.num_docs, tr.config.num_topics
    res, wall, launches = lanczos_solve(B, tr, seed, chunk)
    want = 2 * res.op_calls if segsum.gather_path(1, 4 * D) == "narrow" \
        else 0
    assert launches[NARROW] == want, launches
    with dispatch_before_narrow_and_tiles():
        old, old_wall, old_launches = lanczos_solve(B, tr, seed, chunk)
    assert old_launches[NARROW] == 0, old_launches
    ref = np.asarray(tr.evalues)
    print(f"lanczos at the NYTimes shape: {nev} eigenvalues in {wall:.2f} s "
          f"wall, {res.restarts} restarts, {res.op_calls} operator calls "
          f"({launches[GATHER]} width-1 launches, {launches[NARROW]} on the "
          f"narrow kernel), max rel diff to block_ks "
          f"{np.abs(res.evals / ref - 1).max():.2e}; with the wide kernel "
          f"at width 1 (the dispatch before the narrow kernel) "
          f"{old_wall:.2f} s wall, {old.restarts} restarts, {old.op_calls} "
          f"operator calls, max rel diff to block_ks "
          f"{np.abs(old.evals / ref - 1).max():.2e}; {card_line()}")
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((V, 1), generator=g).to(B.device)
    y = sparse.bt_x(B, x, chunk)
    d_stream = (B.d_doc, B.d_word, B.d_val)
    w_stream = (B.w_word, B.w_doc, B.w_val)
    uses = {NARROW: [], GATHER: []}
    for kernel in (NARROW, GATHER):
        k = "narrow" if kernel == NARROW else "wide"
        n = res.op_calls if kernel == NARROW else 0
        uses[kernel] += [
            gather_use("Lanczos B^T x, width 1", *d_stream, x, D, n,
                       kernel=k),
            gather_use("Lanczos B y, width 1", *w_stream, y, V, n, kernel=k),
        ]
    # the crossover: both kernels on the same random tables
    faster = []
    for W in CROSSOVER_WIDTHS:
        X = torch.randn((V, W), generator=g).to(B.device)
        Y = torch.randn((D, W), generator=g).to(B.device)
        rows = [gather_use(f"crossover B^T X, width {W}", *d_stream, X, D, 0,
                           kernel="narrow", beside=("wide",)),
                gather_use(f"crossover B Y, width {W}", *w_stream, Y, V, 0,
                           kernel="narrow", beside=("wide",))]
        uses[NARROW] += rows
        if all(r["ms"] < r["beside_ms"]["wide"] for r in rows):
            faster.append(W)
        print(f"  crossover at width {W}: narrow / wide kernel B^T X "
              f"{rows[0]['ms']:.3f} / {rows[0]['beside_ms']['wide']:.3f} ms,"
              f" B Y {rows[1]['ms']:.3f} / {rows[1]['beside_ms']['wide']:.3f}"
              f" ms")
    top = max((W for W in faster if all(v in faster for v in
                                        CROSSOVER_WIDTHS if v <= W)),
              default=0)
    print(f"crossover: the narrow kernel was faster on both streams at "
          f"widths {faster}, without a gap up to {top}; the dispatch gives "
          f"it widths up to segsum.NARROW_MAX_WIDTH = "
          f"{segsum.NARROW_MAX_WIDTH}")
    print_uses(uses, "Lanczos solve")
    return uses, launches


def reports_phase(gpu, cpu) -> None:
    """Phase S4: the spectrum of A, the catchword-free model and edge
    topics v1 of the small corpus, card against CPU (the same top-two
    pairs go to both v1 constructions)."""
    from isle_tpu_torch.topic_model import construct_edge_topics_v1

    out = {}
    for name, tr in (("cuda", gpu), ("cpu", cpu)):
        tr.compute_input_svd()
        tr.output_avg_topic_coherence()
        spectrum = np.loadtxt(os.path.join(tr.run_dir,
                                           "A_squared_spectrum.txt"))
        m_hat = np.loadtxt(os.path.join(tr.run_dir, "M_hat_avg"), ndmin=2)
        edge, sel = construct_edge_topics_v1(
            tr._device_A(), *cpu.top_pairs, None, TINY["k"], TINY["edges"],
            min_docs=cpu.config.hyper.edge_topic_min_docs)
        assert tr._device_A().device.type == name
        out[name] = (spectrum, m_hat, edge, sel)
    g, c = out["cuda"], out["cpu"]
    np.testing.assert_allclose(g[0], c[0], rtol=1e-4)
    np.testing.assert_allclose(g[1], c[1], atol=1e-5)
    np.testing.assert_allclose(g[2], c[2], atol=1e-5)
    assert np.array_equal(g[3], c[3]) and len(g[3]) > 0
    print(f"tiny reports: card == CPU (A_squared_spectrum max rel diff "
          f"{np.abs(g[0] / c[0] - 1).max():.2e}, M_hat_avg max abs diff "
          f"{np.abs(g[1] - c[1]).max():.2e}, edge topics v1: "
          f"{len(g[3])} pairs equal, max abs diff "
          f"{np.abs(g[2] - c[2]).max():.2e})")


INFER_SLICE_DOCS = 20_000
# the sharded trainer's stage labels beside the in-core stage each stands for
SHARDED_STAGES = {
    "upload A to device (sharded)": "upload A to device",
    "computing thresholds": "computing thresholds",
    "creating thresholded and scaled matrix (sharded)":
        "creating thresholded and scaled matrix",
    "eigen solve (B B^T, sharded)": "eigen solve (B B^T)",
    "project docs": "project docs",
    "k-means seeds initialization": "k-means seeds initialization",
    "converging Lloyds k-means on B_k": "converging Lloyds k-means on B_k",
    "k-means on B (sharded)": "k-means on B",
    "collecting word freqs in clusters (sharded)":
        "collecting word freqs in clusters",
    "finding catchwords for clusters": "finding catchwords for clusters",
    "constructing topic vectors (sharded)": "constructing topic vectors",
}


@contextlib.contextmanager
def no_library_spmm():
    """torch's sparse product and sparse constructors raise inside: a run
    that passes took every product through the port's kernels."""
    def refuse(*a, **kw):
        raise AssertionError("the port called a torch.sparse routine")

    names = ("mm", "addmm", "sum")
    saved = {n: getattr(torch.sparse, n) for n in names}
    ctors = {n: getattr(torch, n) for n in
             ("sparse_coo_tensor", "sparse_csr_tensor")}
    for n in names:
        setattr(torch.sparse, n, refuse)
    for n in ctors:
        setattr(torch, n, refuse)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.sparse, n, fn)
        for n, fn in ctors.items():
            setattr(torch, n, fn)


def one_rank_mesh(out: str):
    """A sharding.Mesh of this process alone: over a one-rank NCCL group
    (rendezvous: a file under `out`) where torch.distributed has NCCL,
    else without a group. Returns (mesh, the line that says which)."""
    import torch.distributed as dist

    from isle_tpu_torch.sharding import Mesh

    if not (dist.is_available() and dist.is_nccl_available()):
        return Mesh("cuda"), ("torch.distributed has no NCCL on this host: "
                              "the mesh has NO process group, every "
                              "collective is the identity")
    os.makedirs(out, exist_ok=True)
    rendezvous = os.path.join(out, "nccl_rendezvous")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", init_method=f"file://{rendezvous}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=300),
        device_id=torch.device("cuda", torch.cuda.current_device()))
    mesh = Mesh.from_process_group("cuda")
    # the first collective makes NCCL's communicator: outside every timing
    mesh.all_reduce(torch.zeros(8, device="cuda"))
    torch.cuda.synchronize()
    return mesh, (f"one-rank NCCL group (world size {mesh.world}, rank "
                  f"{mesh.rank}), made and warmed in "
                  f"{time.perf_counter() - t0:.2f} s")


def sharded_phase(corpus, shape, seed, out, tr, mesh, per_incore,
                  name: str = "nyt_m", label: str = "sharded") -> tuple:
    """Phase M1 (and Z4 on the bite corpus): the sharded run written
    under `name`, printed as `label`, against the in-core run `tr` whose
    launches by stage are `per_incore`. Returns (the sharded trainer, its
    launch counts, its launches by stage)."""
    from isle_tpu_torch import segsum

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls0, sec0 = mesh.collective_calls, mesh.collective_seconds()
    segsum.reset_launch_counts()
    t0 = time.perf_counter()
    with no_library_spmm():
        sh = train(corpus, shape, seed, "cuda", os.path.join(out, name),
                   mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segsum.launch_counts()
    coll_s = mesh.collective_seconds() - sec0
    per = stage_launches(sh)
    print(f"{label} path, world size {mesh.world}: train + edge topics "
          f"{wall:.2f} s wall, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, kernel "
          f"launches {launches}; {mesh.collective_calls - calls0} "
          f"collectives, {coll_s:.4f} s inside them ({coll_s / wall:.2%} of "
          f"the wall); {card_line()}")
    for stage, w, _ in sh.timer.phases:
        print(f"  {label} stage {stage}: {w:.3f} s")
    assert sh.mesh is mesh and sh.A is None
    ours, ref = run_dir_arrays(sh, "svd"), run_dir_arrays(tr, "svd")
    assert np.array_equal(ours["zetas"], ref["zetas"]), "sharded zetas"
    assert np.array_equal(ours["original_cols"], ref["original_cols"])
    assert np.array_equal(sh.cluster_of_doc, tr.cluster_of_doc), \
        "sharded clusters differ from the in-core run's"
    for t, (a, b) in enumerate(zip(sh.catchwords, tr.catchwords)):
        assert np.array_equal(a, b), f"sharded run: catchwords of topic {t}"
    np.testing.assert_allclose(sh.evalues, tr.evalues, rtol=1e-4)
    np.testing.assert_allclose(sh.model, tr.model, rtol=0, atol=1e-6)
    for a, b in zip(sh.top_pairs, tr.top_pairs):
        assert np.array_equal(a, b), "sharded run: top-two topics"
    assert np.array_equal(sh.edge_pairs, tr.edge_pairs)
    # stage by stage the launches of the in-core run: each rank's local
    # products are the same wrappers. The in-core B stage also logs
    # Frob(B), one more launch of the doc norms.
    for stage, counts in per.items():
        want = dict(per_incore[SHARDED_STAGES.get(stage, stage)])
        if stage.startswith("creating thresholded"):
            want[ONEHOT] -= 1
        assert counts == want, \
            f"sharded stage {stage!r} launched {counts}, in core {want}"
    assert per["eigen solve (B B^T, sharded)"][GATHER] == \
        2 * sh.op_counter.calls
    print(f"{label} checks: zetas, original_cols, clusters, catchwords, "
          "top-two topics and edge pairs equal the in-core run's; model max "
          f"abs diff {np.abs(sh.model - tr.model).max():.3e} (bit-equal: "
          f"{np.array_equal(sh.model, tr.model)}), eigenvalues bit-equal: "
          f"{np.array_equal(sh.evalues, tr.evalues)}; no torch.sparse call; "
          "launches by stage (segsum_onehot, segsum_gather_rows): "
          + "; ".join(f"{stage} ({c[ONEHOT]}, {c[GATHER]})"
                      for stage, c in per.items()))
    return sh, launches, per


def sharded_infer_phase(tr, entries, shape, out, mesh) -> None:
    """Phase M2: the first INFER_SLICE_DOCS docs inferred on one device
    and doc-parallel over the mesh."""
    from isle_tpu_torch import GpuConfig, InferConfig, Inferencer

    d, w, c = entries
    n = min(INFER_SLICE_DOCS, shape["docs"])
    keep = d < n
    sub = make_corpus((d[keep], w[keep], c[keep]), dict(shape, docs=n),
                      normalize_to_one=True)
    V, k = tr.model.shape
    res, walls = {}, {}
    for name, m in (("single", None), ("mesh", mesh)):
        inf = Inferencer(InferConfig(num_topics=k, vocab_size=V),
                         model=tr.model, quiet=True, mesh=m,
                         output_dir=os.path.join(out, f"infer_m_{name}"),
                         gpu=GpuConfig(device="cuda"))
        calls0 = mesh.collective_calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[name] = inf.infer_corpus(sub, top_n=5)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        if m is not None and mesh.group is not None:
            assert mesh.collective_calls > calls0, "no gather at the end"
    g, r = res["mesh"], res["single"]
    assert np.array_equal(g.converged, r.converged), \
        "doc-parallel inference: convergence flags differ"
    np.testing.assert_allclose(g.weights, r.weights, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(g.llh_per_doc, r.llh_per_doc, rtol=2e-5,
                               atol=1e-5)
    print(f"doc-parallel inference, world size {mesh.world}, {n} docs: "
          f"{walls['mesh']:.3f} s wall (single device {walls['single']:.3f} "
          f"s), {g.num_converged} converged, weights bit-equal to the "
          f"single-device run: {np.array_equal(g.weights, r.weights)}")


def train_step_phase(corpus, shape, seed, tr, mesh) -> tuple:
    """Phase T: sharding.sharded_train_step on the rank's B over the mesh,
    at full width. Returns (the word histogram's use, the step's launches
    by use, the path's launch counts)."""
    from isle_tpu_torch import kmeans, segsum, sparse
    from isle_tpu_torch import sharding as shd

    V, D, k = corpus.vocab_size, corpus.num_docs, shape["k"]
    A = shd.shard_doc_sparse(corpus.rows, corpus.doc_ids(), corpus.vals, V, D,
                             mesh)
    zetas = torch.from_numpy(run_dir_arrays(tr, "svd")["zetas"]).cuda()
    B, _ = shd.sharded_threshold_and_copy(A, zetas, mesh)
    del A
    L = B.local
    assert B.docs_per_shard == L.num_docs, \
        "phase T's gates hold without isle_tpu's pads: --docs must be a " \
        "multiple of 8"
    X = torch.from_numpy(np.random.default_rng(seed + 9).standard_normal(
        (V, 128)).astype(np.float32)).cuda()
    centers = torch.from_numpy(np.ascontiguousarray(tr.centers,
                                                    np.float32)).cuda()
    step = shd.sharded_train_step(B, mesh, k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    calls0 = mesh.collective_calls
    segsum.reset_launch_counts()
    first = step(B, X, centers)  # the warm-up
    torch.cuda.synchronize()
    per_step = segsum.launch_counts()
    collectives = mesh.collective_calls - calls0
    sec0 = mesh.collective_seconds()
    events = []
    t0 = time.perf_counter()
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = step(B, X, centers)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segsum.launch_counts()
    coll_s = mesh.collective_seconds() - sec0
    peak = torch.cuda.max_memory_allocated() - base
    step_ms = [s.elapsed_time(e) for s, e in events]
    assert per_step == {ONEHOT: 2, GATHER: 4, NARROW: 0, TILED: 0}, \
        per_step
    assert launches == {n: (REPS + 1) * c for n, c in per_step.items()}
    assert collectives == (4 if mesh.group is not None else 0), collectives
    print(f"train step (sharding.sharded_train_step, world size "
          f"{mesh.world}), V {V}, B {L.num_docs} docs, {L.nnz} nnz, X width "
          f"128, k {k}: median {float(np.median(step_ms)):.3f} ms of "
          f"{REPS} steps after a warm-up (CUDA events: "
          + ", ".join(f"{t:.3f}" for t in step_ms)
          + f"; host {wall / REPS * 1e3:.3f} ms a step), launches a step "
          f"{per_step}, {collectives} collectives a step, "
          f"{coll_s / REPS * 1e3:.3f} ms a step inside them, peak "
          f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held "
          f"before; {card_line()}")

    # the gates, at world size 1: every output against the single-device
    # functions on the rank's B
    Y, assign, new_centers, hist = res
    for a, b in zip(first, res):
        assert torch.equal(a, b), "two steps differ"
    assert torch.equal(Y, sparse.gram_x(L, X)), "Y != sparse.gram_x"
    dots = sparse.bt_x(L, centers.T.contiguous())
    ref_assign = kmeans._assign(dots, sparse.doc_l2sq(L), centers)
    assert torch.equal(assign.long(), ref_assign), "assign != kmeans._assign"
    assert torch.equal(new_centers,
                       kmeans.update_centers_full(L, ref_assign, k)), \
        "new_centers != update_centers_full"
    words = L.d_word.cpu().numpy()
    assert np.array_equal(hist.cpu().numpy(),
                          np.bincount(words, minlength=V).astype(np.float32))
    print(f"train step checks: Y bit-equal to sparse.gram_x, assign equal "
          f"to kmeans._assign ({len(np.unique(assign.cpu().numpy()))} "
          f"clusters used), new_centers bit-equal to update_centers_full, "
          f"hist equal to np.bincount; six steps bit-equal")
    use = onehot_use("word histogram (train step)", L.w_word, None, None, V,
                     1, REPS + 1,
                     library=lambda: torch.bincount(L.w_word,
                                                    minlength=V + 1))
    print_uses({ONEHOT: [use]}, "train-step path")
    n = REPS + 1
    by_use = {"eigensolver B^T X": n, "eigensolver B Y": n,
              "Lloyd's B^T C (+ projection)": n, "Lloyd's B onehot": n,
              "doc norms of B": n, use["use"]: n}
    return use, by_use, launches


def graft_entry_phase() -> dict:
    """graft_entry.entry() on the card against entry("cpu"), then
    dryrun_multichip(1) on the card in a process of its own. Returns the
    launch counts of the entry's step."""
    from isle_tpu_torch import graft_entry, segsum, sparse

    fn, args = graft_entry.entry("cuda")
    cfn, cargs = graft_entry.entry("cpu")
    segsum.reset_launch_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    launches = segsum.launch_counts()
    # X is 128 wide and k = 16: each width takes its kernel
    narrow = sum(segsum.gather_path(w_, 0) == "narrow"
                 for w_ in (128, 128, 16, 16))
    assert launches == {ONEHOT: 1, GATHER: 4, NARROW: narrow, TILED: 0}, \
        launches
    Y, assign, centers, w = (o.cpu() for o in got)
    cY, c_assign, c_centers, cw = cfn(*cargs)
    sp, X, C = cargs[:3]
    # |B| (|B|^T |X|) in float64: the scale of each element's rounding
    absx = segsum.segsum_gather_rows_plain(
        sp.d_doc, sp.d_word, sp.d_val.double().abs(), X.double().abs(),
        sp.num_docs)[:sp.num_docs]
    scale = segsum.segsum_gather_rows_plain(
        sp.w_word, sp.w_doc, sp.w_val.double().abs(), absx, sp.vocab)[
            :sp.vocab]
    y_err = float(((Y.double() - cY.double()).abs() / scale).max())
    assert y_err <= 1e-5, f"entry Y: max err / (|B| |X|) {y_err}"
    # a doc may take another cluster only where its two best distances tie
    flips = torch.nonzero(assign != c_assign)[:, 0]
    dist = (sparse.doc_l2sq(sp).double()[:, None]
            + (C.double() ** 2).sum(1)[None, :]
            - 2.0 * sparse.bt_x(sp, C.T.contiguous()).double())
    for d in flips.tolist():
        a, b = dist[d, assign[d]], dist[d, c_assign[d]]
        assert abs(a - b) <= 1e-5 * abs(b), f"entry: doc {d} moved off a tie"
    moved = set(assign[flips].tolist()) | set(c_assign[flips].tolist())
    same = [c for c in range(C.shape[0]) if c not in moved]
    torch.testing.assert_close(centers[same], c_centers[same], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(w, cw, rtol=1e-5, atol=1e-5)
    print(f"graft_entry.entry() on the card against the CPU: Y max err / "
          f"(|B| |X|) {y_err:.3e}, {len(flips)} assignments moved on ties, "
          f"centers max abs diff "
          f"{float((centers - c_centers).abs().max()):.3e}, w max abs diff "
          f"{float((w - cw).abs().max()):.3e}; launches "
          f"{launches}")

    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "isle_tpu_torch.graft_entry", "--device",
         "cuda", "--dryrun", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    print(run.stdout.rstrip())
    assert run.returncode == 0, (f"graft_entry --dryrun 1 exited "
                                 f"{run.returncode}:\n{run.stderr[-6000:]}")
    ok = [line for line in run.stdout.splitlines()
          if line.startswith("dryrun_multichip OK")]
    assert len(ok) == 3, run.stdout
    print(f"graft_entry --device cuda --dryrun 1: rc 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def capi_phase(out: str) -> None:
    """Phase M3: the C shim built from the checkout and the plain-C smoke
    host of native/ run against it on the card."""
    from isle_tpu_torch import _build_capi

    t0 = time.perf_counter()
    lib = _build_capi.build_shim()
    smoke = os.path.join(out, "capi_smoke")
    os.makedirs(out, exist_ok=True)
    subprocess.run(
        [shutil.which("cc") or "gcc", "-O2", "-Wall", "-o", smoke,
         os.path.join(ROOT, "native", "capi_smoke.c"), "-ldl", "-lm"],
        check=True, capture_output=True, text=True, timeout=300)
    built = time.perf_counter() - t0
    env = dict(os.environ, ISLE_CAPI_DEVICE="cuda", ISLE_CAPI_EDGE_TOPICS="6",
               PYTHONPATH=os.pathsep.join([ROOT] + [p for p in sys.path
                                                    if p]))
    t0 = time.perf_counter()
    run = subprocess.run([smoke, lib], env=env, capture_output=True,
                         text=True, timeout=600, cwd=out)
    assert run.returncode == 0 and "CAPI SMOKE OK" in run.stdout, \
        f"capi_smoke failed ({run.returncode}):\n{run.stdout}{run.stderr}"
    print(f"C shim: {os.path.relpath(lib)} built with g++ and the smoke "
          f"host with cc in {built:.2f} s; native/capi_smoke.c on cuda in "
          f"{time.perf_counter() - t0:.2f} s: {run.stdout.strip()}")


def _union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, -1.0
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def eigensolve_split(events: list, window=None) -> dict:
    """Where the eigensolve's time went, from the events of a
    torch.profiler trace: the window (lo, hi) in the trace's
    microseconds, by default the stage's, cut by the trainer's stage
    markers of a GpuConfig.profile_dir trace; a kernel belongs to the
    operator whose CPU-side call launched it (by the trace's correlation
    ids). Milliseconds, and the CUDA runtime's synchronize calls in the
    window by the outermost operator around each."""
    from isle_tpu_torch.obs import STAGE_MARK

    events = [e for e in events if e.get("ph") == "X"]
    if window is None:
        marks = sorted((e["ts"], e["name"][len(STAGE_MARK):])
                       for e in events
                       if e.get("name", "").startswith(STAGE_MARK))
        labels = [name for _, name in marks]
        assert "eigen solve (B B^T)" in labels, labels
        i = labels.index("eigen solve (B B^T)")
        window = marks[i - 1][0], marks[i][0]
    lo, hi = window

    def inside(e):
        return lo <= e["ts"] < hi

    def spans(name):
        ops = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "cpu_op" and e["name"] == name
                     and inside(e))
        return ops, [a for a, _ in ops]

    qr_ops, qr_starts = spans("aten::linalg_qr")
    mm_ops, mm_starts = spans("aten::mm")
    eigh_ops, eigh_starts = spans("aten::linalg_eigh")

    def within(ops, starts, ts):
        j = bisect.bisect_right(starts, ts) - 1
        return j >= 0 and ts < ops[j][1]

    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    device = {"SpMM kernels (segsum_gather_rows)": 0.0,
              "Ritz eigh (kernels launched by aten::linalg_eigh)": 0.0,
              "QR (kernels launched by aten::linalg_qr)": 0.0,
              "matmuls (kernels launched by aten::mm)": 0.0,
              "other kernels": 0.0, "copies": 0.0}
    busy = []
    n_kernels = 0
    for e in events:
        cat = e.get("cat")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset") or not inside(e):
            continue
        busy.append((e["ts"], e["ts"] + e["dur"]))
        ts = launch_ts.get(e.get("args", {}).get("correlation"), e["ts"])
        if cat != "kernel":
            key = "copies"
        elif "segsum" in e["name"]:
            key = "SpMM kernels (segsum_gather_rows)"
        elif within(eigh_ops, eigh_starts, ts):
            key = "Ritz eigh (kernels launched by aten::linalg_eigh)"
        elif within(qr_ops, qr_starts, ts):
            key = "QR (kernels launched by aten::linalg_qr)"
        elif within(mm_ops, mm_starts, ts):
            key = "matmuls (kernels launched by aten::mm)"
        else:
            key = "other kernels"
        n_kernels += cat == "kernel"
        device[key] += e["dur"] / 1e3
    span_ms = (hi - lo) / 1e3
    host = {}
    for name in ("aten::linalg_eigh", "aten::linalg_qr", "aten::mm"):
        host[name] = sum(e["dur"] for e in events if e.get("cat") == "cpu_op"
                         and e["name"] == name and inside(e)) / 1e3
    host["synchronizes and blocking copies (cuda runtime)"] = sum(
        e["dur"] for e in events if e.get("cat") == "cuda_runtime"
        and inside(e) and ("Synchronize" in e["name"]
                           or e["name"].startswith("cudaMemcpy"))) / 1e3
    # the runtime's synchronize calls by the outermost operator around
    # each (the Python-level call that made it)
    ops = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("cat") == "cpu_op" and inside(e)]
    syncs = collections.Counter()
    for e in events:
        if e.get("cat") == "cuda_runtime" and inside(e) \
                and "Synchronize" in e["name"]:
            around = [o for o in ops
                      if o[0] <= e["ts"] and e["ts"] + e["dur"] <= o[1]]
            outer = max(around, key=lambda o: o[1] - o[0])[2] if around \
                else "no operator"
            syncs[f"{e['name']} in {outer}"] += 1
    return dict(window_ms=span_ms, device_ms=device,
                device_idle_ms=span_ms - _union_seconds(busy) / 1e3,
                host_ms=host, kernels=n_kernels, sync_calls=syncs,
                qr_calls=len(qr_ops), mm_calls=len(mm_ops),
                eigh_calls=len(eigh_ops))


def traced_phase(corpus, shape, seed, out, tr) -> tuple:
    """Phase M4. Returns (launch counts, launches by stage) of the traced
    run."""
    from isle_tpu_torch import segsum
    from isle_tpu_torch.obs import STAGE_MARK

    profile_dir = os.path.join(out, "profile")
    shutil.rmtree(profile_dir, ignore_errors=True)
    torch.cuda.synchronize()
    segsum.reset_launch_counts()
    t0 = time.perf_counter()
    traced = train(corpus, shape, seed, "cuda", os.path.join(out, "nyt_p"),
                   profile_dir=profile_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segsum.launch_counts()
    traced.A = None
    assert np.array_equal(traced.cluster_of_doc, tr.cluster_of_doc) and \
        np.array_equal(traced.model, tr.model), \
        "the traced run differs from the untraced one"
    files = os.listdir(profile_dir)
    assert len(files) == 1 and files[0].endswith(".json"), files
    path = os.path.join(profile_dir, files[0])
    t0 = time.perf_counter()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels, "the trace holds no CUDA kernel event"
    assert any("segsum" in e["name"] for e in kernels), \
        "the trace holds none of the port's kernels"
    marks = [e["name"][len(STAGE_MARK):] for e in events
             if e.get("name", "").startswith(STAGE_MARK)]
    assert marks == [label for label, _ in traced.stage_launches], marks
    n_events = len(events)
    del kernels
    split = eigensolve_split(events)
    del events
    stage = dict((label, w) for label, w, _ in traced.timer.phases)[
        "eigen solve (B B^T)"]
    print(f"traced run (GpuConfig.profile_dir): train + edge topics "
          f"{wall:.2f} s wall with the profiler on (trace export "
          f"included), trace {os.path.getsize(path) / 2**20:.1f} MiB, "
          f"{n_events} events, read in {time.perf_counter() - t0:.1f} s; "
          f"results equal the untraced run's; {card_line()}")
    loop = "block_ks_device" if traced.gpu.device_loop_solver else "block_ks"
    print(f"  eigensolve under the profiler ({loop}): stage {stage:.3f} s, "
          f"window between its markers {split['window_ms']:.1f} ms; "
          f"device idle {split['device_idle_ms']:.1f} ms (the host loop "
          f"block_ks in an earlier trace of this stage on an H100 80GB "
          f"HBM3 at 700 W: {HOST_LOOP_EIGENSOLVE_IDLE_MS} ms)")
    print_split(split)
    return launches, stage_launches(traced)


def print_split(split: dict) -> None:
    print(f"    {split['kernels']} kernels, {split['eigh_calls']} eigh "
          f"calls, {split['qr_calls']} QR calls, {split['mm_calls']} mm "
          f"calls, {sum(split['sync_calls'].values())} synchronize calls ("
          + "; ".join(f"{name} x {n}"
                      for name, n in sorted(split["sync_calls"].items()))
          + "); device: "
          + "; ".join(f"{name} {ms:.1f} ms"
                      for name, ms in split["device_ms"].items())
          + f"; device idle {split['device_idle_ms']:.1f} ms; host: "
          + "; ".join(f"{name} {ms:.1f} ms"
                      for name, ms in split["host_ms"].items()))


# ---------------------------------------------------------------------------
# Phase E: the eigensolver's two loops, linalg.block_ks_device (the
# default) and linalg.block_ks (GpuConfig.device_loop_solver=False)
# ---------------------------------------------------------------------------

E_SOLVES = 3  # timed solves of each loop, in turn
# the host loop's idle device time in a trace of the eigensolve stage at
# the NYTimes shape, H100 80GB HBM3 at 700 W, before the device loop
HOST_LOOP_EIGENSOLVE_IDLE_MS = 292.0
LOOPS = ("block_ks_device", "block_ks")


@contextlib.contextmanager
def host_waits():
    """The host's waits on the card inside the block as PyTorch reports
    them: with torch.cuda.set_sync_debug_mode("warn") every synchronizing
    call (a stream synchronize, a blocking copy, item(), eigh's check of
    its info) warns. Each warning is counted by its site, the innermost
    frame of isle_tpu_torch/linalg.py on the stack (function, source
    line), else the warning's own file and line; the yielded namespace
    holds the Counter `sites` and, at exit, the total `n`."""
    import traceback
    import warnings

    box = SimpleNamespace(n=0, sites=collections.Counter())
    linalg_py = os.path.join("isle_tpu_torch", "linalg.py")

    def count(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if f.filename.endswith(linalg_py)]
        box.sites[(ours[-1].name, ours[-1].line.strip()) if ours else
                  (os.path.basename(filename), f"line {lineno}")] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = count
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode(0)
    box.n = sum(box.sites.values())


def restart_waits(sites: collections.Counter) -> tuple:
    """A device-loop solve's waits by where they stand: (inside a restart's
    expand steps, Ritz step and truncate {site: n}, at the stop test's
    readback of the converged count (`nconv = int(...)`, in
    block_ks_device's nested `restart`), elsewhere: the start and the
    end)."""
    def stop_test(site):
        return (site[0] in ("block_ks_device", "restart")
                and site[1].startswith("nconv = int("))

    inside = {site: n for site, n in sites.items()
              if site[0] in ("_expand", "_ritz", "_truncate", "restart")
              and not stop_test(site)}
    stop = sum(n for site, n in sites.items() if stop_test(site))
    return inside, stop, sum(sites.values()) - sum(inside.values()) - stop


def basis_groups(U: np.ndarray, U2: np.ndarray, evals: np.ndarray,
                 rel_gap: float = 1e-2) -> list:
    """Two eigenbases of one operator compared where each is determined:
    the eigenvalues (descending) cut into groups wherever two neighbours
    lie more than rel_gap apart (relative); for each group (first column,
    size, the smallest singular value of U[:, G]^T U2[:, G]: 1 when both
    span the same subspace, |cos| of the two columns for a single one).
    With residuals below tol * lambda (the stop test) Davis-Kahan bounds
    each basis's angle to the group's invariant subspace by tol /
    rel_gap, 1e-2 at tol 1e-4, so the two agree to a cosine of at least
    1 - 1e-3 whatever the rounding inside a group of close eigenvalues."""
    M = U.astype(np.float64).T @ U2.astype(np.float64)
    cuts = [0] + [j for j in range(1, len(evals))
                  if evals[j - 1] - evals[j] > rel_gap * evals[j - 1]] \
        + [len(evals)]
    return [(a, b - a, float(np.linalg.svd(M[a:b, a:b],
                                           compute_uv=False).min()))
            for a, b in zip(cuts[:-1], cuts[1:])]


def eig_solve(loop: str, B, tr, seed: int, max_restarts=None):
    """One solve of linalg.<loop> on B B^T with the trainer's operator,
    options and a fresh Draws(seed) (the main path's start block),
    launch counts set to 0 just before and read just after, host waits
    counted by site (host_waits). Returns (result, wall s, launch counts,
    host waits by site, peak device bytes above what was held before)."""
    from isle_tpu_torch import linalg, segsum
    from isle_tpu_torch.matops import mat_gram_x
    from isle_tpu_torch.rng import Draws

    hp, chunk = tr.config.hyper, tr.gpu.seg_chunk
    if max_restarts is None:
        max_restarts = hp.block_ks_max_iters
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    segsum.reset_launch_counts()
    with host_waits() as waits:
        t0 = time.perf_counter()
        res = getattr(linalg, loop)(
            lambda X: mat_gram_x(B, X, chunk), B.vocab, tr.config.num_topics,
            Draws(seed), B.device, blk=hp.block_ks_block_size,
            tol=hp.block_ks_tolerance, max_restarts=max_restarts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return (res, wall, segsum.launch_counts(), waits.sites,
            torch.cuda.max_memory_allocated() - held)


def traced_solve(loop: str, B, tr, seed: int, out: str) -> dict:
    """One solve of `loop` under torch.profiler; its split
    (eigensolve_split) over the window of a record_function around it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("phase E solve"):
            eig_solve(loop, B, tr, seed)
    path = os.path.join(out, f"phase_e_{loop}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span = [e for e in events if e.get("name") == "phase E solve"
            and e.get("cat") == "user_annotation"]
    assert len(span) == 1, span
    return eigensolve_split(events, (span[0]["ts"],
                                     span[0]["ts"] + span[0]["dur"]))


def ritz_eigh_probe(Hs: torch.Tensor) -> dict:
    """The Ritz step alone on one K x K projected matrix of a solve (float32
    on the card): torch.linalg.eigh in float64 on the card, its host
    waits, its ms by CUDA events and by the host's clock (mean of REPS
    after a warm-up; each call waits for its own check), whether two
    calls are bit-equal; beside it block_ks's step, float32 LAPACK on the
    host with the copies both ways."""
    H64 = Hs.to(torch.float64)
    H64 = (H64 + H64.T) * 0.5
    with host_waits() as waits:
        torch.linalg.eigh(H64)
    w1, W1 = torch.linalg.eigh(H64)
    w2, W2 = torch.linalg.eigh(H64)
    events_ms = time_ms(lambda: torch.linalg.eigh(H64))

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / REPS

    def lapack():
        w, W = torch.linalg.eigh(((Hs + Hs.T) * 0.5).cpu())
        return w.to(Hs.device), W.to(Hs.device)

    return dict(K=Hs.shape[0], waits=waits.n, events_ms=events_ms,
                host_ms=host_ms(lambda: torch.linalg.eigh(H64)),
                lapack_ms=host_ms(lapack),
                bit_equal=bool(torch.equal(w1, w2) and torch.equal(W1, W2)))


def device_loop_phase(tr, seed: int, out: str) -> None:
    """Phase E at the NYTimes shape on phase 4's B (rebuilt from the run's
    ζ, with the trainer's doc tiles): block_ks_device and block_ks with
    the same draws, E_SOLVES solves each in turn. Gates: the device loop's
    solves bit-equal to each other and its eigenvalues to the main
    path's; nconv, restarts, operator calls and launch counts equal
    between the loops, two gather calls an operator call; eigenvalues
    within rtol 1e-4; the bases up to sign where an eigenvalue stands
    alone and as subspaces where eigenvalues lie within 1% of each other
    (basis_groups: every group's cosine at least 1 - 1e-3); a restart of
    the device loop waits on the host only at eigh's own check and at
    the stop test (host_waits by site: inside a restart only eigh's line,
    as often as eigh alone waits, a truncate; one stop-test readback a
    truncate); two float64 eighs on the card bit-equal. Printed: the
    waits of both loops by site, the Ritz eigh alone on the card and
    LAPACK's on the host, the median walls, the peak memory above what
    was held, the largest elementwise difference of the lone columns,
    and one traced solve of each loop: the device's idle time, the split
    and the runtime's synchronize calls by the operator that made them."""
    from isle_tpu_torch import bmatrix, linalg, sparse, thresholds

    A = tr.A
    hp, k = tr.config.hyper, tr.config.num_topics
    zetas, _ = thresholds.compute_thresholds(
        A, tr.corpus.avg_doc_sz, tr.corpus.nz_docs, k, hp)
    B, cols = bmatrix.threshold_and_copy(A, zetas)
    assert np.array_equal(cols, tr.original_cols), "B differs from the run's"
    B = sparse.with_doc_tiles(B)
    del zetas

    # the first truncate alone, its projected matrix kept for the probe
    kept = []
    ritz = linalg._ritz

    def keep_matrix(H, K, on_host):
        kept.append(H[:K, :K].clone())
        return ritz(H, K, on_host)

    linalg._ritz = keep_matrix
    try:
        eig_solve("block_ks_device", B, tr, seed, max_restarts=0)
    finally:
        linalg._ritz = ritz
    probe = ritz_eigh_probe(kept[-1])
    del kept

    runs = {loop: [] for loop in LOOPS}
    for _ in range(E_SOLVES):
        for loop in LOOPS:
            runs[loop].append(eig_solve(loop, B, tr, seed))
    dev, host = runs["block_ks_device"][0][0], runs["block_ks"][0][0]
    truncates = dev.restarts + 1
    U = dev.evecs.cpu().numpy()
    U_host = linalg.align_signs(host.evecs.cpu().numpy(), U)
    groups = basis_groups(U, U_host, dev.evals)
    alone = [a for a, size, _ in groups if size == 1]
    alone_diff = float(np.abs(U_host[:, alone] - U[:, alone]).max()) \
        if alone else 0.0
    worst = min(groups, key=lambda g: g[2])
    ev_rel = np.abs(host.evals / dev.evals - 1)
    inside, stop, elsewhere = restart_waits(runs["block_ks_device"][0][3])
    walls = {loop: float(np.median([r[1] for r in rs]))
             for loop, rs in runs.items()}
    traced = {loop: traced_solve(loop, B, tr, seed, out) for loop in LOOPS}
    card = card_line()
    print(f"phase E, the eigensolver's loops on phase 4's B (K x K = "
          f"{probe['K']} x {probe['K']}): " + "; ".join(
              f"{loop} {rs[0][0].restarts} restarts, nconv "
              f"{rs[0][0].nconv}/{k}, {rs[0][0].op_calls} operator calls, "
              f"launches {rs[0][2]}, walls "
              + ", ".join(f"{r[1]:.3f}" for r in rs)
              + f" s (median {walls[loop]:.3f}), host waits "
              + ", ".join(str(sum(r[3].values())) for r in rs)
              + f", peak {max(r[4] for r in rs) / 2**20:.1f} MiB above "
              f"what was held" for loop, rs in runs.items()) + f"; {card}")
    print(f"  device loop against host loop: eigenvalues max rel diff "
          f"{ev_rel.max():.3e}; {len(groups)} groups of eigenvalues within "
          f"1% ({len(alone)} alone, the largest of "
          f"{max(g[1] for g in groups)}), smallest cosine {worst[2]:.6f} "
          f"(the group of {worst[1]} from column {worst[0]}, eigenvalue "
          f"{dev.evals[worst[0]]:.6g}); the lone columns up to sign max abs "
          f"diff {alone_diff:.3e}; groups (first column, size, cosine): "
          + ", ".join(f"({a}, {n}, {c:.6f})" for a, n, c in groups if n > 1)
          + "; the device loop's solves bit-equal to each other and its "
          "eigenvalues to the main path's")
    for loop, rs in runs.items():
        print(f"  host waits of {loop} by site (sync debug mode, one solve, "
              f"{rs[0][0].restarts + 1} truncates): " + "; ".join(
                  f"{name}: {line} x {n}"
                  for (name, line), n in sorted(rs[0][3].items())))
    print(f"  the device loop's waits: {sum(inside.values())} inside its "
          f"restarts (eigh's check), {stop} at the stop test, {elsewhere} "
          f"at the start and the end: "
          f"{(sum(inside.values()) + stop) / truncates:g} a restart; "
          f"torch.linalg.eigh alone waits {probe['waits']} time(s) a call")
    print(f"  the Ritz step alone on the first truncate's matrix: float64 "
          f"eigh on the card {probe['events_ms']:.3f} ms (CUDA events), "
          f"{probe['host_ms']:.3f} ms a call (host clock), two calls "
          f"bit-equal: {probe['bit_equal']}; float32 LAPACK on the host "
          f"with the copies {probe['lapack_ms']:.3f} ms; {card}")
    for loop, split in traced.items():
        print(f"  traced solve, {loop}: window {split['window_ms']:.1f} ms, "
              f"device idle {split['device_idle_ms']:.1f} ms")
        print_split(split)

    for r in runs["block_ks_device"][1:]:
        assert np.array_equal(r[0].evals, dev.evals) and torch.equal(
            r[0].evecs, dev.evecs), "two device-loop solves differ"
    assert np.array_equal(dev.evals, tr.evalues), \
        "the device loop's eigenvalues differ from the main path's"
    assert probe["bit_equal"], "two float64 eighs on the card differ"
    for r in runs["block_ks"] + runs["block_ks_device"]:
        assert (r[0].nconv, r[0].restarts, r[0].op_calls) == \
            (dev.nconv, dev.restarts, dev.op_calls), \
            (r[0].nconv, r[0].restarts, r[0].op_calls, dev.nconv,
             dev.restarts, dev.op_calls)
        assert r[2] == runs["block_ks_device"][0][2], (r[2], runs)
    assert dev.nconv == k, f"nconv {dev.nconv}/{k}"
    launches = runs["block_ks_device"][0][2]
    assert launches[GATHER] == 2 * dev.op_calls, launches
    np.testing.assert_allclose(host.evals, dev.evals, rtol=1e-4)
    assert worst[2] >= 1 - 1e-3, f"the bases differ: {worst}"
    assert {name for name, _ in inside} <= {"_ritz"} \
        and sum(inside.values()) == truncates * probe["waits"], inside
    assert stop == truncates, f"{stop} stop-test readbacks"


# ---------------------------------------------------------------------------
# Phase H: the hybrid layout (hybrid.py), the port's default engine
# ---------------------------------------------------------------------------

# a partial head on the small corpus: 200 of its 2,000 words
TINY_HEAD_BYTES = 2 * TINY["docs"] * 200
# the in-core stages beside the hybrid run's that launch alike
HYBRID_SHARED_STAGES = ("eigen solve (B B^T)", "project docs",
                        "k-means on B", "collecting word freqs in clusters",
                        "constructing topic vectors")


def head_counts_host(B) -> np.ndarray:
    """(vocab,) entries per word of B, counted on the host."""
    return np.bincount(B.w_word.cpu().numpy(), minlength=B.vocab)


def host_head_words(B, R: int) -> np.ndarray:
    """The head words recomputed on the host: the R highest counts, the
    lower word id first among equal counts (jax.lax.top_k's order)."""
    order = np.argsort(-head_counts_host(B), kind="stable")
    return np.sort(order[:R]).astype(np.int32)


def within_norm_bound(got, seg, idx, val, table, S, frob_b) -> tuple:
    """Requires `got` within 1e-5 ||B|| ||X|| (Frobenius norms) of the
    float64 COO product (the plain version on B's stream). Returns (the
    error over that bound, the largest elementwise error over |B| |X|,
    which is printed: the head sums up to 300,000 docs in one float32
    accumulator)."""
    from isle_tpu_torch import segsum

    ref = segsum.segsum_gather_rows_plain(seg, idx, val.double(),
                                          table.double(), S)[:S]
    scale = segsum.segsum_gather_rows_plain(seg, idx, val.double().abs(),
                                            table.double().abs(), S)[:S]
    diff = got.double() - ref
    norm = float(torch.linalg.norm(diff)) / (
        frob_b * float(torch.linalg.norm(table.double())))
    rel = diff.abs() / scale.clamp(min=1e-300)
    at = divmod(int(rel.argmax()), rel.shape[1])
    print(f"  largest elementwise error at {at}: got {float(got[at]):.9g}, "
          f"float64 {float(ref[at]):.9g}, |B| |X| {float(scale[at]):.9g}, "
          f"{int((seg == at[0]).sum())} entries in its segment")
    assert norm <= 1e-5, f"hybrid product: ||err|| / (||B|| ||X||) {norm}"
    return norm, float(rel.max())


def head_product_uses(H) -> list:
    """The head product alone (hybrid.head_dot: one bf16 GEMM with a
    float32 output over the operand's three bf16 pieces) at the widths
    the path gives it, both directions, against its plain version (the
    head upcast to float32, one float32 matmul) and its bound: the head
    read once at 3.35 TB/s or 3 x 2 R D W operations at the bf16 peak."""
    from isle_tpu_torch import hybrid

    R, D = H.num_head, H.num_docs
    g = torch.Generator().manual_seed(1)
    rows = []
    for W in (128, 100, 1):
        for transpose in (True, False):
            X = torch.randn((R if transpose else D, W), generator=g).cuda()
            got = hybrid.head_dot(H.head, X, transpose)
            again = hybrid.head_dot(H.head, X, transpose)
            assert torch.equal(got, again), "head product: two launches"
            plain = hybrid.head_dot_plain(H.head, X, transpose)
            err = float((got - plain).abs().max())
            scale = float(hybrid.head_dot_plain(H.head, X.abs(),
                                                transpose).max())
            assert err <= 1e-5 * scale, f"head product W={W}: {err}"
            del plain
            t_bytes = R * D * 2 / HBM_BYTES_PER_S
            t_ops = 3 * 2 * R * D * W / BF16_FLOPS
            rows.append(dict(
                width=W, direction="head^T X" if transpose else "head Y",
                ms=time_ms(lambda: hybrid.head_dot(H.head, X, transpose)),
                plain_ms=time_ms(lambda: hybrid.head_dot_plain(
                    H.head, X, transpose)),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=err, bit_equal=True))
    return rows


def hybrid_uses(hy, H, B, seed: int) -> dict:
    """The tail's uses of both kernels in the hybrid run (its launches per
    use from the run's own counters), each against its plain version as
    phase 5 does it, on the tail's streams."""
    k = hy.config.num_topics
    calls, reps = hy.op_counter.calls, lloyds_reps(hy)
    T = H.tail
    g = torch.Generator().manual_seed(seed + 1)
    X = torch.randn((B.vocab, hy.config.hyper.block_ks_block_size),
                    generator=g).cuda()
    Y = torch.randn((B.num_docs, X.shape[1]), generator=g).cuda()
    centers = torch.as_tensor(hy.centers).T.contiguous().cuda()
    assign = torch.as_tensor(hy.cluster_of_doc[hy.original_cols]).long()
    onehot = torch.nn.functional.one_hot(assign, k).to(torch.float32).cuda()
    d_stream = (T.d_doc, T.d_word, T.d_val)
    w_stream = (T.w_word, T.w_doc, T.w_val)
    t_stream = (T.t_word, T.t_doc, T.t_val, T.tile_starts)
    uses = {
        ONEHOT: [onehot_use("doc norms of the hybrid tail", T.d_doc, None,
                            T.d_val * T.d_val, T.num_docs, 1, 1)],
        GATHER: [
            gather_use("hybrid tail B^T X, eigensolver", *d_stream, X,
                       T.num_docs, calls),
            gather_use("hybrid tail Lloyd's B^T C (+ projection)", *d_stream,
                       centers, T.num_docs, reps + 1),
        ],
        TILED: [],
    }
    # the word-sorted products: the tiled passes where the dispatch takes
    # them, the untiled kernel beside them
    for use, table, n in (("hybrid tail B Y, eigensolver", Y, calls),
                          ("hybrid tail Lloyd's B onehot", onehot, reps)):
        tiled = tiles_taken(T, table)
        uses[GATHER].append(gather_use(use, *w_stream, table, T.vocab,
                                       0 if tiled else n))
        uses[TILED].append(gather_use(use + ", tiled", *w_stream, table,
                                      T.vocab, n if tiled else 0,
                                      kernel="tiled", tiles=t_stream))
    return uses


def tiles_taken(sp, table) -> bool:
    """Whether sparse.b_y on `sp` takes the tiled passes for `table`."""
    from isle_tpu_torch import segsum

    return segsum.gather_path(table.shape[1], table.numel() * 4,
                              sp.tile_rows) == "tiled"


def hybrid_phase(corpus, shape, seed, out, tr, per_incore, tiny) -> tuple:
    """Phase H1: the default configuration (the hybrid layout) at full
    width against the COO main path `tr` (per_incore: its launches by
    stage), three repeated runs bit-equal
    to the first, the layout against a host recomputation, the products
    against the COO's, and the per-call numbers; the small corpus with a
    partial head, card against CPU. Returns (the run, its launch counts,
    its launches by stage, the tail's uses, {walls, peak, held}: the
    runs' walls, the first run's peak GiB and what was held before it)."""
    from isle_tpu_torch import bmatrix, hybrid, segsum, sparse

    check_tiny(tiny, seed, out, "hybrid, 200 head rows",
               head_bytes=TINY_HEAD_BYTES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    segsum.reset_launch_counts()
    head_calls = hybrid.head_dot.calls
    t0 = time.perf_counter()
    hy = train(corpus, shape, seed, "cuda", os.path.join(out, "nyt_h"),
               head_bytes=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segsum.launch_counts()
    head_calls = hybrid.head_dot.calls - head_calls
    peak = torch.cuda.max_memory_allocated() / 2**30
    per = stage_launches(hy)
    from isle_tpu_torch import GpuConfig

    budget = hy.gpu.dense_head_bytes
    assert budget == GpuConfig().dense_head_bytes > 0, budget
    print(f"hybrid path (GpuConfig's default, dense_head_bytes {budget}): "
          f"train + edge topics {wall:.2f} s wall, peak device memory "
          f"{peak:.2f} GiB ({held:.2f} GiB of it held before the run), "
          f"kernel launches {launches}, head GEMMs {head_calls}; "
          f"{card_line()}")
    for label, w, _ in hy.timer.phases:
        print(f"  hybrid stage {label}: {w:.3f} s")
    assert "creating thresholded matrix (fused hybrid)" in per, per
    assert head_calls > 0 and launches[GATHER] > 0 and launches[ONEHOT] > 0

    # the same answers as the COO run where the layout cannot matter
    ours, ref = run_dir_arrays(hy, "svd"), run_dir_arrays(tr, "svd")
    assert np.array_equal(ours["zetas"], ref["zetas"]), "hybrid zetas"
    assert np.array_equal(ours["original_cols"], ref["original_cols"])
    np.testing.assert_allclose(hy.evalues, tr.evalues, rtol=1e-4)
    # stage by stage the COO run's launches, but for the eigensolve's
    # count of operator calls, which rounding may move
    # (the tail's B Y and B onehot run the tiled passes: one launch each
    # counted as a segsum_gather_rows call and one as a tiled call)
    blk = hy.config.hyper.block_ks_block_size
    D = len(hy.original_cols)
    tiled = {w_: segsum.gather_path(w_, 4 * w_ * D, sparse.DOC_TILE)
             == "tiled" for w_ in (blk, hy.config.num_topics)}
    for stage in HYBRID_SHARED_STAGES:
        got, want = per[stage], per_incore[stage]
        if stage.startswith("eigen"):
            calls = hy.op_counter.calls
            assert got == {ONEHOT: 0, GATHER: 2 * calls, NARROW: 0,
                           TILED: calls * tiled[blk]}, got
        else:
            assert (got[ONEHOT], got[GATHER]) == \
                (want[ONEHOT], want[GATHER]), (stage, got, want)
    assert launches[TILED] >= hy.op_counter.calls * tiled[blk], launches

    # the shipped runs in turn with runs on the dispatch before the
    # narrow kernel and the tiled passes (untiled tail products)
    walls, before = [wall], []
    for again in ("nyt_h0", "nyt_h2", "nyt_h3", "nyt_h4", "nyt_h5"):
        path = os.path.join(out, again)
        if again in ("nyt_h0", "nyt_h5"):
            before.append(train_untiled(corpus, shape, seed, path, hy,
                                        head_bytes=None))
        else:
            walls.append(train_again(corpus, shape, seed, path, hy,
                                     head_bytes=None))

    # the layout, rebuilt from the run's ζ as the trainer builds it
    A = hy._device_A()
    z = torch.from_numpy(ours["zetas"]).cuda()
    B, cols = bmatrix.threshold_and_copy(A, z)
    t0 = time.perf_counter()
    H, hcols, _ = hybrid.hybrid_from_thresholds(A, z, budget)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert np.array_equal(hcols, cols)
    R, D = H.num_head, H.num_docs
    want_R = min(B.vocab, budget // (2 * A.num_docs),
                 hybrid.max_head_rows(A.num_docs))
    assert R == want_R, (R, want_R)
    assert np.array_equal(H.head_words.cpu().numpy(), host_head_words(B, R))
    assert H.head.stride(0) % 8 == 0 and H.nnz == B.nnz
    counts = head_counts_host(B)
    assert H.head_nnz == int(counts[H.head_words.cpu().numpy()].sum())
    head_gb = R * D * 2 / 1e9
    print(f"hybrid layout: {R} head rows (budget rule min(vocab, "
          f"{budget} // (2 x {A.num_docs}), max_head_rows {want_R})), head "
          f"{R} x {D} bf16 = {head_gb:.3f} GB, {H.head_nnz} of {H.nnz} nnz "
          f"in the head ({H.head_nnz / H.nnz:.2%}), head density "
          f"{H.head_nnz / (R * D):.3%}, tail {H.tail.nnz} nnz; head words "
          f"equal the host's recomputation; built in {build_s:.3f} s")

    # the products against the COO's on the same operands
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((B.vocab, 128), generator=g).cuda()
    Y = sparse.bt_x(B, X)
    frob_b = float(torch.sqrt(sparse.frobenius_sq(B)))
    errs = {
        "h_bt_x": within_norm_bound(hybrid.h_bt_x(H, X), B.d_doc, B.d_word,
                                    B.d_val, X, B.num_docs, frob_b),
        "h_b_y": within_norm_bound(hybrid.h_b_y(H, Y), B.w_word, B.w_doc,
                                   B.w_val, Y, B.vocab, frob_b),
    }
    whole = {
        "h_bt_x width 128": time_ms(lambda: hybrid.h_bt_x(H, X)),
        "COO bt_x width 128": time_ms(lambda: sparse.bt_x(B, X)),
        "h_b_y width 128": time_ms(lambda: hybrid.h_b_y(H, Y)),
        "COO b_y width 128": time_ms(lambda: sparse.b_y(B, Y)),
        "h_doc_l2sq": time_ms(lambda: hybrid.h_doc_l2sq(H)),
        "COO doc_l2sq": time_ms(lambda: sparse.doc_l2sq(B)),
    }
    del X, Y
    print("hybrid products against the float64 COO product on one X "
          "(||err|| / (||B|| ||X||), and the largest elementwise err / "
          "(|B| |X|)): " + ", ".join(f"{k_} {v[0]:.2e}, {v[1]:.2e}"
                                      for k_, v in errs.items())
          + "; whole calls: " + "; ".join(f"{k_} {v:.3f} ms"
                                          for k_, v in whole.items()))
    for row in head_product_uses(H):
        print(f"  head product [{row['direction']}, width {row['width']}]: "
              f"{row['ms']:.3f} ms, plain (head upcast, float32 matmul) "
              f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}), max abs err to plain "
              f"{row['max_abs_err']:.2e}, two launches bit-equal")
    uses = hybrid_uses(hy, H, B, seed)
    print_uses(uses, "hybrid path")
    for name in (ONEHOT, GATHER, TILED):
        need = sum(u["launches"] for u in uses[name])
        assert launches[name] >= need, (name, launches[name], need)
    del H, B, A
    hy.A = None
    torch.cuda.empty_cache()

    # printed, not gated: how far the clustering moved from the COO run's
    same_docs = float(np.mean(hy.cluster_of_doc == tr.cluster_of_doc))
    cw_same = sum(np.array_equal(a, b)
                  for a, b in zip(hy.catchwords, tr.catchwords))
    print(f"hybrid against COO (printed): clusters equal on {same_docs:.4%} "
          f"of docs, {cw_same} of {len(tr.catchwords)} topics with equal "
          f"catchwords ({sum(len(c) for c in hy.catchwords)} catchwords, COO "
          f"{sum(len(c) for c in tr.catchwords)}), eigenvalues max rel diff "
          f"{np.abs(hy.evalues / tr.evalues - 1).max():.2e}, walls of the "
          f"four hybrid runs {', '.join(f'{w:.2f}' for w in walls)} s; on "
          f"the dispatch before the tiled passes (runs 2 and 6 of six) "
          f"{', '.join(f'{w:.2f}' for w in before)} s; {card_line()}")
    return hy, launches, per, uses, dict(walls=walls, peak=peak, held=held)


# ---------------------------------------------------------------------------
# Phase HC: GpuConfig.break_head_cap, the head past isle_tpu's int32 cap
# ---------------------------------------------------------------------------

# the head budgets of phase HC, each with the switch: 2x and 4x the cap's
# rows at the NYTimes shape (14,316 and 28,633 against 7,153)
CAP_BREAK_BUDGETS = (8 << 30, 16 << 30)
KMEANS_STAGES = ("k-means seeds initialization",
                 "converging Lloyds k-means on B_k", "k-means on B")


def stage_walls(tr) -> dict:
    """The eigensolve's and k-means' seconds of a run."""
    w = collections.defaultdict(float)
    for label, sec, _ in tr.timer.phases:
        w[label] += sec
    return {"eigensolve": w["eigen solve (B B^T)"],
            "k-means": sum(w[k] for k in KMEANS_STAGES)}


def head_row_sums_exact(H, counts: np.ndarray) -> None:
    """The head's row sums, counted on the card in float32 a block of
    rows at a time (each at most the doc count, exact below 2^24),
    equal the host's counts of its words."""
    sums = torch.cat([H.head[r:r + 1024].sum(dim=1, dtype=torch.float32)
                      for r in range(0, H.num_head, 1024)]).cpu().numpy()
    want = counts[H.head_words.cpu().numpy()].astype(np.float32)
    assert np.array_equal(sums, want), "head row sums differ from the host"


def product_parts(H, X, Y) -> dict:
    """The head part and the tail part of one h_bt_x and one h_b_y at X's
    width (H a HybridSparse, or a COO DocSparse: all tail), each timed
    with its bound: bytes (the head or the tail's stream, the operand
    and the output once) over the HBM rate, or operations (the head's 3
    x 2 R D W at the bf16 peak, the tail's 2 n W at the float32 one)."""
    from isle_tpu_torch import hybrid, sparse

    W = X.shape[1]
    T = H.tail if isinstance(H, hybrid.HybridSparse) else H
    V, D, n = T.vocab, T.num_docs, T.nnz
    parts = {
        "tail B^T X": (lambda: sparse.bt_x(T, X),
                       bound(n * 12 + V * W * 4 + D * W * 4, 2 * n * W)),
        "tail B Y": (lambda: sparse.b_y(T, Y),
                     bound(n * 12 + D * W * 4 + V * W * 4, 2 * n * W)),
    }
    if T is not H:
        R = H.num_head
        hw = H.head_words.long()
        head_bound = bound(R * D * 2 + R * W * 4 + D * W * 4,
                           3 * 2 * R * D * W, BF16_FLOPS)

        def head_b_y():
            out = hybrid.head_dot(H.head, Y[:D], transpose=False)
            return out * H.row_scale[hw][:, None]

        parts["head B^T X"] = (lambda: hybrid.head_bt_x(H, X), head_bound)
        parts["head B Y"] = (head_b_y, head_bound)
    return {name: dict(ms=time_ms(fn), bound_ms=b[0], bound_by=b[1])
            for name, (fn, b) in parts.items()}


def cap_break_layout(A, z, budget: int, cap_off: bool, B, frob_b: float,
                     X, Y) -> dict:
    """The layout of phase HC's run, rebuilt from its ζ as the trainer
    builds it, gated (head rows by the rule, head words and row sums
    against the host, nnz, both products within 1e-5 ||B|| ||X|| of the
    float64 COO product, two Gram operator calls bit-equal) and its
    parts timed. Returns the row of the printed table."""
    from isle_tpu_torch import hybrid

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    H, _, _ = hybrid.hybrid_from_thresholds(A, z, budget,
                                            break_head_cap=cap_off)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    R, D = H.num_head, H.num_docs
    rule = min(B.vocab, max(8, budget // (2 * A.num_docs)))
    want = rule if cap_off else min(rule, hybrid.max_head_rows(A.num_docs))
    assert R == want, (R, want)
    assert np.array_equal(H.head_words.cpu().numpy(), host_head_words(B, R))
    counts = head_counts_host(B)
    head_row_sums_exact(H, counts)
    assert H.head_nnz == int(counts[H.head_words.cpu().numpy()].sum())
    assert H.head_nnz + H.tail.nnz == B.nnz, (H.head_nnz, H.tail.nnz)
    assert H.head.stride(0) % 8 == 0
    errs = (within_norm_bound(hybrid.h_bt_x(H, X), B.d_doc, B.d_word,
                              B.d_val, X, B.num_docs, frob_b),
            within_norm_bound(hybrid.h_b_y(H, Y), B.w_word, B.w_doc, B.w_val,
                              Y, B.vocab, frob_b))
    g1, g2 = hybrid.h_gram_x(H, X), hybrid.h_gram_x(H, X)
    assert torch.equal(g1, g2), f"R = {R}: two h_gram_x launches differ"
    del g1, g2
    row = dict(R=R, cap_off=cap_off, head_share=H.head_nnz / H.nnz,
               build_s=build_s, head_gib=R * H.head.stride(0) * 2 / 2**30,
               errs=errs, parts=product_parts(H, X, Y))
    print(f"phase HC layout, budget {budget} "
          f"({'break_head_cap' if cap_off else 'capped'}): R = {R} (rule "
          f"{rule}, cap {hybrid.max_head_rows(A.num_docs)}), head {R} x {D} "
          f"bf16 = {row['head_gib']:.2f} GiB, {H.head_nnz} of {H.nnz} nnz "
          f"in the head ({row['head_share']:.2%}), tail {H.tail.nnz}, "
          f"built in {build_s:.3f} s; head words and row sums equal the "
          f"host's; h_bt_x, h_b_y ||err|| / (||B|| ||X||) {errs[0][0]:.2e}, "
          f"{errs[1][0]:.2e}; two h_gram_x bit-equal")
    del H
    torch.cuda.empty_cache()
    return row


def cap_break_phase(corpus, shape, seed, out, tr, coo_run, hy, h_run,
                    h_per) -> dict:
    """Phase HC: Trainer.train() + train_edge_topics() with
    GpuConfig(dense_head_bytes=8 GiB, then 16 GiB, break_head_cap=True)
    at the NYTimes shape, each against phase 4's COO run `tr`
    (eigenvalues within rtol 1e-4, ζ and original_cols equal) and phase
    H1's hybrid run `hy` (the launches of the stages the layout does not
    change), model columns summing to 1 within 1e-5; each run's layout
    rebuilt and gated (cap_break_layout), and the layout at 8 GiB without
    the switch, the cap's 7,153 rows. Prints the table of R = 0 (phase
    4) / 7,153 / 14,316 / 28,633. Returns the kernels' launches over
    both training runs."""
    import gc

    from isle_tpu_torch import bmatrix, hybrid, segsum, sparse

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    # the words B holds: a head of as many rows leaves the tail empty, and
    # then no stage launches a kernel on it (only on a cut corpus)
    A = tr._device_A()
    z = torch.from_numpy(run_dir_arrays(tr, "svd")["zetas"]).cuda()
    B, _ = bmatrix.threshold_and_copy(A, z)
    words = int(np.count_nonzero(head_counts_host(B)))
    del B
    total = collections.Counter()
    runs = []
    for budget in CAP_BREAK_BUDGETS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        segsum.reset_launch_counts()
        head_calls = hybrid.head_dot.calls
        t0 = time.perf_counter()
        run = train(corpus, shape, seed, "cuda",
                    os.path.join(out, f"nyt_hc{budget >> 30}"),
                    head_bytes=budget, break_head_cap=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = segsum.launch_counts()
        head_calls = hybrid.head_dot.calls - head_calls
        peak = torch.cuda.max_memory_allocated() / 2**30
        total.update(launches)
        per = stage_launches(run)
        assert run.gpu.break_head_cap and head_calls > 0
        assert "creating thresholded matrix (fused hybrid)" in per, per
        ours, ref = run_dir_arrays(run, "svd"), run_dir_arrays(tr, "svd")
        assert np.array_equal(ours["zetas"], ref["zetas"])
        assert np.array_equal(ours["original_cols"], ref["original_cols"])
        np.testing.assert_allclose(run.evalues, tr.evalues, rtol=1e-4)
        model = run.model
        assert np.isfinite(model).all() and np.isfinite(run.edge_model).all()
        sums = model.sum(axis=0, dtype=np.float64)
        assert np.all(~model.any(axis=0) | (np.abs(sums - 1.0) <= 1e-5)), \
            sums
        # stage by stage phase H1's launches, but for the eigensolve's
        # count of operator calls, which rounding may move (its tail B Y
        # on the tiled passes where H1's took them)
        blk = run.config.hyper.block_ks_block_size
        tiled = segsum.gather_path(blk, 4 * blk * len(run.original_cols),
                                   sparse.DOC_TILE) == "tiled"
        R = min(corpus.vocab_size, budget // (2 * corpus.num_docs))
        assert R < words or shape["docs"] != NYT["docs"], (R, words)
        for stage in HYBRID_SHARED_STAGES if R < words else ():
            got, want = per[stage], h_per[stage]
            if stage.startswith("eigen"):
                calls = run.op_counter.calls
                assert got == {ONEHOT: 0, GATHER: 2 * calls, NARROW: 0,
                               TILED: calls * tiled}, got
                assert want[TILED] == hy.op_counter.calls * tiled, want
            else:
                assert got == want, (stage, got, want)
        if R >= words:
            print(f"CUT: phase HC's {R} head rows hold all {words} words of "
                  "B: the tail is empty, the stage launches are not gated")
        print(f"phase HC run, dense_head_bytes {budget}, break_head_cap: "
              f"train + edge topics {wall:.2f} s wall, peak device memory "
              f"{peak:.2f} GiB ({held:.2f} GiB held before the run), kernel "
              f"launches {launches}, head GEMMs {head_calls}; eigenvalues "
              f"max rel diff to the COO run "
              f"{np.abs(run.evalues / tr.evalues - 1).max():.2e}, clusters "
              f"equal to the COO run's on "
              f"{np.mean(run.cluster_of_doc == tr.cluster_of_doc):.4%} of "
              f"docs; {card_line()}")
        for label, w, _ in run.timer.phases:
            print(f"  phase HC stage {label}: {w:.3f} s")
        runs.append(dict(run=run, wall=wall, peak=peak, held=held))
        run.A = None
        del run
        gc.collect()
        torch.cuda.empty_cache()

    # the layouts, rebuilt from the runs' ζ (all equal phase 4's)
    B, _ = bmatrix.threshold_and_copy(A, z)
    frob_b = float(torch.sqrt(sparse.frobenius_sq(B)))
    # X from the seed and Y = B^T X, as phase H1 takes them: a head word's
    # terms in B Y share a sign, the hard case for one float32 sum
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((B.vocab, 128), generator=g).cuda()
    Y = sparse.bt_x(B, X)
    Bt = sparse.with_doc_tiles(B)
    rows = [dict(R=0, head_share=0.0, build_s=0.0,
                 parts=product_parts(Bt, X, Y))]
    del Bt
    rows.append(cap_break_layout(A, z, CAP_BREAK_BUDGETS[0], False, B,
                                 frob_b, X, Y))
    for budget in CAP_BREAK_BUDGETS:
        rows.append(cap_break_layout(A, z, budget, True, B, frob_b, X, Y))
    assert [r["R"] for r in rows] == [0, 7153, 14316, 28633] or \
        shape["docs"] != NYT["docs"], [r["R"] for r in rows]
    del A, B, X, Y
    torch.cuda.empty_cache()

    walls = [dict(wall=coo_run["wall"], peak=coo_run["peak"],
                  held=coo_run["held"], **stage_walls(tr)),
             dict(wall=h_run["walls"][0], peak=h_run["peak"],
                  held=h_run["held"], **stage_walls(hy))]
    walls += [dict(wall=r["wall"], peak=r["peak"], held=r["held"],
                   **stage_walls(r["run"])) for r in runs]
    print(f"phase HC table (width 128; ms, bound in brackets; walls s; peak "
          f"GiB, what was held before the run in brackets; {card_line()}):")
    print("  R | head share | build s | head B^T X | tail B^T X | head B Y "
          "| tail B Y | eigensolve | k-means | train + edge | peak")
    for row, w in zip(rows, walls):
        p = row["parts"]

        def cell(name):
            if name not in p:
                return "-"
            return f"{p[name]['ms']:.3f} ({p[name]['bound_ms']:.3f})"

        print(f"  {row['R']} | {row['head_share']:.2%} | "
              f"{row['build_s']:.3f} | {cell('head B^T X')} | "
              f"{cell('tail B^T X')} | {cell('head B Y')} | "
              f"{cell('tail B Y')} | {w['eigensolve']:.3f} | "
              f"{w['k-means']:.3f} | {w['wall']:.2f} | "
              f"{w['peak']:.2f} ({w['held']:.2f})")
    print(f"phase HC: {time.perf_counter() - t_phase:.1f} s")
    return total


@contextlib.contextmanager
def seedings():
    """The k-means seed doc ids of every training run inside the block,
    in order (a list; trainer.kmeans_init_on_projected wrapped)."""
    from isle_tpu_torch import trainer

    seen = []
    real = trainer.kmeans_init_on_projected

    def keep(*a, **kw):
        out = real(*a, **kw)
        seen.append(None if out[0] is None else out[0].cpu().numpy())
        return out

    trainer.kmeans_init_on_projected = keep
    try:
        yield seen
    finally:
        trainer.kmeans_init_on_projected = real


def clusters_up_to_labels(a: np.ndarray, b: np.ndarray, k: int) -> float:
    """Share of docs in the cluster of `b` that most of their cluster of
    `a` went to: the agreement of two partitions whatever their labels."""
    C = np.zeros((k, k), np.int64)
    np.add.at(C, (a, b), 1)
    return float(C.max(axis=1).sum() / len(a))


def cross_layout_phase(corpus, shape, seed, out) -> None:
    """Phase H4: the two layouts held against each other where the
    clusters are well defined: the corpus at k = CROSS_LAYOUT_K (the
    synthetic corpus plants 64 word bands; at k = 100 they split in no
    fixed way), trained in the default hybrid layout and in COO, both
    with the host-driven eigensolver loop (device_loop_solver=False: with
    the default loop the COO run's k-means++ parts from the host loop's
    at a tie of its draws, see phase E below). Gates, the bounds of
    tests/test_variants.py's cross-layout test: clusters equal on more
    than 99% of docs, eigenvalues within rtol 1e-4. Prints the model's
    max abs difference and the topics with equal catchwords.

    Then phase E's trainings: each layout once more with the default
    loop, block_ks_device, held against its host-loop run. Eigenvalues
    within rtol 1e-4; where the two runs' k-means++ seedings are equal,
    clusters equal on more than 99% of docs; where they part, only at a
    tie of the draw: the seeds equal up to the first that differs, and
    that one the next or the previous doc (the uniform fell on the
    boundary between two docs of the cumulative sum, which float32
    rounding of the distances moves), the agreement then printed with and
    without the labels."""
    k_shape = dict(shape, k=CROSS_LAYOUT_K)
    runs, walls, seeds = {}, {}, {}
    for label, head_bytes, device_loop in (
            ("COO", 0, False), ("hybrid", None, False),
            ("COO, device loop", 0, True), ("hybrid, device loop", None,
                                            True)):
        t0 = time.perf_counter()
        with seedings() as seen:
            tr = train(corpus, k_shape, seed, "cuda",
                       os.path.join(out, f"nyt_k{CROSS_LAYOUT_K}_"
                                    f"{label.replace(', ', '_')}"),
                       head_bytes=head_bytes, device_loop=device_loop)
            torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        seeds[label] = seen[-1]
        tr.A = None
        torch.cuda.empty_cache()
        runs[label] = tr
    coo, hy = runs["COO"], runs["hybrid"]
    same = float(np.mean(hy.cluster_of_doc == coo.cluster_of_doc))
    ev_rel = float(np.abs(np.asarray(hy.evalues) / np.asarray(coo.evalues)
                          - 1).max())
    cw_same = sum(np.array_equal(a, b)
                  for a, b in zip(hy.catchwords, coo.catchwords))
    print(f"hybrid against COO at k = {CROSS_LAYOUT_K} (both on the host "
          f"loop): clusters equal on "
          f"{same:.4%} of docs, eigenvalues max rel diff {ev_rel:.2e}, model "
          f"max abs diff {np.abs(hy.model - coo.model).max():.3e}, "
          f"{cw_same} of {len(coo.catchwords)} topics with equal catchwords "
          f"({sum(len(c) for c in hy.catchwords)} catchwords, COO "
          f"{sum(len(c) for c in coo.catchwords)}); walls COO "
          f"{walls['COO']:.2f} s, hybrid {walls['hybrid']:.2f} s; "
          f"{card_line()}")
    assert same > 0.99, f"the layouts' clusters agree on only {same:.4%}"
    np.testing.assert_allclose(hy.evalues, coo.evalues, rtol=1e-4)

    stage = {label: dict((s, w) for s, w, _ in t.timer.phases)[
        "eigen solve (B B^T)"] for label, t in runs.items()}
    for layout in ("hybrid", "COO"):
        on_card = f"{layout}, device loop"
        dev, host = runs[on_card], runs[layout]
        a, b = seeds[on_card], seeds[layout]
        parted = int(np.argmax(a != b)) if not np.array_equal(a, b) \
            else None
        same = float(np.mean(dev.cluster_of_doc == host.cluster_of_doc))
        relabeled = clusters_up_to_labels(host.cluster_of_doc,
                                          dev.cluster_of_doc, CROSS_LAYOUT_K)
        ev_rel = float(np.abs(np.asarray(dev.evalues)
                              / np.asarray(host.evalues) - 1).max())
        cw_same = sum(np.array_equal(x, y)
                      for x, y in zip(dev.catchwords, host.catchwords))
        seeding = "k-means++ seeds equal" if parted is None else (
            f"k-means++ seeds part at pick {parted} (doc {a[parted]} / "
            f"{b[parted]})")
        print(f"phase E at k = {CROSS_LAYOUT_K}, {layout}: the device loop "
              f"(block_ks_device) against the host loop (block_ks): "
              f"{seeding}; clusters equal on {same:.4%} of docs "
              f"({relabeled:.4%} up to labels), eigenvalues max rel diff "
              f"{ev_rel:.2e}, model max abs diff "
              f"{np.abs(dev.model - host.model).max():.3e}, {cw_same} of "
              f"{len(host.catchwords)} topics with equal catchwords, "
              f"operator calls {dev.op_counter.calls} / "
              f"{host.op_counter.calls}; walls {walls[on_card]:.2f} / "
              f"{walls[layout]:.2f} s, eigensolve stage "
              f"{stage[on_card]:.3f} / {stage[layout]:.3f} s; "
              f"{card_line()}")
        np.testing.assert_allclose(dev.evalues, host.evalues, rtol=1e-4)
        if parted is None:
            assert same > 0.99, \
                f"{layout}: the loops' clusters agree on only {same:.4%}"
        else:
            assert abs(int(a[parted]) - int(b[parted])) == 1, \
                f"{layout}: the seedings part at pick {parted} away from " \
                f"a tie: doc {a[parted]} / {b[parted]}"


def train_untiled(corpus, shape, seed, out, first, head_bytes=0) -> float:
    """One training run on the dispatch before the narrow kernel and the
    tiled passes: no narrow or tiled launch, eigenvalues within rtol 1e-4
    of the shipped run `first`. Prints its wall, its eigensolve and its
    peak; returns the wall."""
    from isle_tpu_torch import segsum

    with dispatch_before_narrow_and_tiles():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        segsum.reset_launch_counts()
        t0 = time.perf_counter()
        old = train(corpus, shape, seed, "cuda", out, head_bytes=head_bytes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = segsum.launch_counts()
    assert launches[TILED] == launches[NARROW] == 0, launches
    np.testing.assert_allclose(old.evalues, first.evalues, rtol=1e-4)
    eig = dict((label, w) for label, w, _ in old.timer.phases)[
        "eigen solve (B B^T)"]
    print(f"training run on the dispatch before the narrow kernel and the "
          f"tiled passes ({'COO' if head_bytes == 0 else 'hybrid'}): "
          f"{wall:.2f} s wall, eigen solve {eig:.3f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({held:.2f} "
          f"GiB of it held before the run)")
    old.A = None
    torch.cuda.empty_cache()
    return wall


def hybrid_sharded_phase(corpus, shape, seed, out, hy, h_per, mesh) -> dict:
    """Phase H2: the sharded trainer with the hybrid layout
    (sharding.shard_hybrid) over M1's one-rank mesh, against the in-core
    hybrid run as M1 is held to the COO one. Returns its launch counts."""
    from isle_tpu_torch import segsum

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls0, sec0 = mesh.collective_calls, mesh.collective_seconds()
    segsum.reset_launch_counts()
    t0 = time.perf_counter()
    with no_library_spmm():
        sh = train(corpus, shape, seed, "cuda", os.path.join(out, "nyt_mh"),
                   mesh=mesh, head_bytes=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segsum.launch_counts()
    coll_s = mesh.collective_seconds() - sec0
    per = stage_launches(sh)
    print(f"sharded hybrid path, world size {mesh.world}: train + edge "
          f"topics {wall:.2f} s wall, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, kernel "
          f"launches {launches}; {mesh.collective_calls - calls0} "
          f"collectives, {coll_s:.4f} s inside them; {card_line()}")
    for label, w, _ in sh.timer.phases:
        print(f"  sharded hybrid stage {label}: {w:.3f} s")
    assert "hybrid layout (sharded)" in per, per
    ours, ref = run_dir_arrays(sh, "svd"), run_dir_arrays(hy, "svd")
    assert np.array_equal(ours["zetas"], ref["zetas"])
    assert np.array_equal(ours["original_cols"], ref["original_cols"])
    assert np.array_equal(sh.cluster_of_doc, hy.cluster_of_doc), \
        "sharded hybrid clusters differ from the in-core hybrid run's"
    for t, (a, b) in enumerate(zip(sh.catchwords, hy.catchwords)):
        assert np.array_equal(a, b), f"sharded hybrid: catchwords of {t}"
    np.testing.assert_allclose(sh.evalues, hy.evalues, rtol=1e-4)
    np.testing.assert_allclose(sh.model, hy.model, rtol=0, atol=1e-6)
    for stage in ("eigen solve (B B^T, sharded)", "project docs",
                  "k-means on B (sharded)"):
        want = h_per[SHARDED_STAGES[stage]]
        assert per[stage] == want, (stage, per[stage], want)
    print("sharded hybrid checks: zetas, original_cols, clusters and "
          "catchwords equal the in-core hybrid run's; model max abs diff "
          f"{np.abs(sh.model - hy.model).max():.3e} (bit-equal: "
          f"{np.array_equal(sh.model, hy.model)}); the eigensolve, the "
          "projection and k-means launched what the in-core run's did")
    return launches


def hybrid_streamed_phase(corpus, shape, seed, out, hy) -> dict:
    """Phase H3: the 12-chunk streamed trainer with the hybrid layout
    against the in-core hybrid run, as S1 is held to the COO one. Returns
    its launch counts and its trainer."""
    from isle_tpu_torch import hybrid

    st = streamed_trainer(corpus, shape, seed, os.path.join(out, "nyt_sh"),
                          head_bytes=None)
    head_calls = hybrid.head_dot.calls
    wall, peak, launches, per = run_streamed(st)
    head_calls = hybrid.head_dot.calls - head_calls
    print_streamed_run("streamed hybrid path", st, wall, peak, launches)
    check_streamed_launches(per, len(st.loader.ranges),
                            "streamed hybrid path")
    assert "hybrid layout" in per and head_calls > 0, per
    ours, ref = run_dir_arrays(st, "svd"), run_dir_arrays(hy, "svd")
    assert np.array_equal(ours["zetas"], ref["zetas"])
    assert np.array_equal(ours["original_cols"], ref["original_cols"])
    np.testing.assert_allclose(ours["evalues"], ref["evalues"], rtol=1e-4)
    print(f"streamed hybrid checks: zetas and original_cols equal the "
          f"in-core hybrid run's, eigenvalues max rel diff "
          f"{np.abs(ours['evalues'] / ref['evalues'] - 1).max():.2e}; "
          f"{head_calls} head GEMMs; clusters equal the in-core hybrid "
          f"run's: {np.array_equal(st.cluster_of_doc, hy.cluster_of_doc)}")
    return launches, st


def assert_same_run(a, b, label: str) -> None:
    """Run `a` ended bit for bit where run `b` ended: ζ and original_cols
    (the svd checkpoints), clusters, catchwords, top-two topics, the model
    and the edge model."""
    ours, ref = run_dir_arrays(a, "svd"), run_dir_arrays(b, "svd")
    for key in ("zetas", "original_cols"):
        assert np.array_equal(ours[key], ref[key]), f"{label}: {key}"
    assert np.array_equal(a.cluster_of_doc, b.cluster_of_doc), \
        f"{label}: clusters"
    for t, (x, y) in enumerate(zip(a.catchwords, b.catchwords)):
        assert np.array_equal(x, y), f"{label}: catchwords of topic {t}"
    for x, y in zip(a.top_pairs, b.top_pairs):
        assert np.array_equal(x, y), f"{label}: top-two topics"
    for key in ("model", "edge_model", "edge_pairs"):
        assert np.array_equal(getattr(a, key), getattr(b, key)), \
            f"{label}: {key}"


@contextlib.contextmanager
def head_rows_built():
    """The head rows of every hybrid layout the streamed trainer builds
    inside (streaming.to_hybrid's num_head), appended to the list
    yielded."""
    from isle_tpu_torch import streaming

    real, rows = streaming.to_hybrid, []

    def spy(B, num_head, *args, **kw):
        rows.append(int(num_head))
        return real(B, num_head, *args, **kw)

    streaming.to_hybrid = spy
    try:
        yield rows
    finally:
        streaming.to_hybrid = real


@contextlib.contextmanager
def ballast_middle(free_bytes: int):
    """The streamed middle's first attempt (streaming.planned_middle's
    `run`) inside the block starts behind a ballast tensor that leaves
    `free_bytes` of device memory free, and the ballast goes when that
    attempt raises torch.OutOfMemoryError, as a tensor the failed attempt
    held would. Yields a namespace: attempts, ooms (attempts that raised
    it), alloc (each attempt's peak bytes allocated above its start),
    reused (whether each attempt found the eigenpairs of an earlier one),
    ballast_bytes, free (the bytes free at the first attempt's start)."""
    from isle_tpu_torch import streaming

    real = streaming.planned_middle
    spy = SimpleNamespace(attempts=0, ooms=0, alloc=[], reused=[],
                          ballast_bytes=0, free=None)
    ballast = []

    def planned(t, loader, nnz_b, run, agree=None):
        def attempt(head, state):
            spy.attempts += 1
            spy.reused.append("U" in state)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            if spy.attempts == 1:
                free = torch.cuda.mem_get_info()[0]
                spy.ballast_bytes = max(free - free_bytes, 0)
                ballast.append(torch.empty(spy.ballast_bytes,
                                           dtype=torch.uint8, device="cuda"))
                torch.cuda.synchronize()
                spy.free = torch.cuda.mem_get_info()[0]
            a0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            try:
                return run(head, state)
            except torch.OutOfMemoryError:
                spy.ooms += 1
                ballast.clear()
                raise
            finally:
                spy.alloc.append(torch.cuda.max_memory_allocated() - a0)

        return real(t, loader, nnz_b, attempt, agree)

    streaming.planned_middle = planned
    try:
        yield spy
    finally:
        streaming.planned_middle = real
        ballast.clear()
        torch.cuda.empty_cache()


# phase R: the device memory the real out-of-memory run leaves free at
# the start of the middle, far below the 6 GB or so its first attempt
# takes at the NYTimes shape
OOM_FREE_BYTES = 1 << 30


# phase R: GpuConfig.hbm_bytes (GiB) for each of the memory plan's other
# outcomes at the NYTimes shape with the default 4 GiB head budget
RESIDENT_PLANS = ((8, "head shrunk"), (4, "slabs kept, no head"),
                  (2, "slabs released"))


def plan_outcome(keep: bool, head: int, cfg_head: int) -> str:
    if not keep:
        return "slabs released"
    return ("full head" if head == cfg_head else "head shrunk" if head
            else "slabs kept, no head")


def resident_hbm(gib: int, outcome: str, slab: int, nnz: int,
                 cfg_head: int) -> int:
    """`gib` GiB where it gives `outcome` (the NYTimes shape), else (a cut
    corpus) the bytes that give it by plan_middle_budget's terms."""
    from isle_tpu_torch.streaming import plan_middle_budget

    hbm = gib << 30
    if plan_outcome(*plan_middle_budget(hbm, slab, nnz, cfg_head),
                    cfg_head) == outcome:
        return hbm
    hbm = slab + (1 << 30) + {
        "head shrunk": 96 * nnz + cfg_head // 2,
        "slabs kept, no head": 96 * nnz + (128 << 20),
        "slabs released": 30 * nnz - 1}[outcome]
    print(f"CUT: phase R takes hbm_bytes {hbm} for {outcome!r} "
          f"({gib} GiB does not give it at this corpus)")
    return hbm


def resident_phase(corpus, shape, seed, out, st, B, ms, sh, mesh) -> dict:
    """Phase R: the default loader (streaming.ResidentLoader) and the
    middle's memory plan, against S1's wire run `st` (B: its B), H3's
    `sh` and S5's `ms`. Returns {path: launch counts} of its runs."""
    from isle_tpu_torch import streaming
    from isle_tpu_torch.hybrid import max_head_rows

    chunks = len(st.loader.ranges)
    launches = {}
    t0 = time.perf_counter()

    def run(label, path, **kw):
        rs = streamed_trainer(corpus, shape, seed,
                              os.path.join(out, "nyt_R" + path),
                              resident_bytes=None, **kw)
        with head_rows_built() as rows:
            wall, peak, launches[label], per = run_streamed(rs)
        print_streamed_run(label, rs, wall, peak, launches[label])
        check_streamed_launches(per, chunks, label)
        assert isinstance(rs.loader, streaming.ResidentLoader), label
        assert rs.loader.count_dtype == np.uint8, rs.loader.count_dtype
        return rs, rows, per

    # the default run (COO, as S1) against S1's wire run
    rs, rows, per = run("streamed, resident", "")
    loader = rs.loader
    assert loader.fill_count == 1 and loader.held and not rows
    assert_same_run(rs, st, "resident path")
    z = torch.from_numpy(run_dir_arrays(rs, "svd")["zetas"]).cuda()
    RB, cols = streaming.streamed_build_b(corpus, z, None, loader)
    assert np.array_equal(cols, st.original_cols)
    assert_same_b(RB, B)
    del RB
    vals = torch.from_numpy(corpus.vals)
    off = corpus.offsets
    for lo, hi, w, v, d in loader.chunks():
        want = vals[int(off[lo]):int(off[hi])].cuda()
        assert torch.equal(v.view(torch.int32), want.view(torch.int32)), \
            f"resident path: the values of docs [{lo}, {hi})"
    assert loader.fill_count == 1
    slab, copied = loader.slab_bytes, rs.run_bytes_copied
    print(f"resident checks: zetas, original_cols, B ({B.nnz} nnz), "
          f"clusters, catchwords, top-two topics, model and edge model "
          f"equal S1's bit for bit (eigenvalues too: "
          f"{np.array_equal(rs.evalues, st.evalues)}); every chunk's "
          f"values equal corpus.vals bit for bit; {copied} bytes copied "
          f"to the card against S1's {st.run_bytes_copied} "
          f"({st.run_bytes_copied / max(copied, 1):.2f} x), one fill in "
          f"{loader.fill_seconds:.4f} s")
    del rs, loader

    # the planner's outcomes under the default head budget (hybrid)
    held, full_rows, _ = run("streamed, resident, hybrid", "_h",
                             head_bytes=None)
    assert held.loader.fill_count == 1 and len(full_rows) == 1
    assert_same_run(held, sh, "resident hybrid path")
    nb, V = B.num_docs, shape["vocab"]
    cfg_head = held.gpu.dense_head_bytes
    for gib, outcome in RESIDENT_PLANS:
        hbm = resident_hbm(gib, outcome, slab, B.nnz, cfg_head)
        keep, head = streaming.plan_middle_budget(hbm, slab, B.nnz, cfg_head)
        assert plan_outcome(keep, head, cfg_head) == outcome
        label = f"streamed, resident, hbm {gib} GiB"
        got, rows, per = run(label, f"_{gib}", head_bytes=None,
                             hbm_bytes=hbm)
        if outcome == "head shrunk":
            assert keep and 0 < head < cfg_head, (keep, head)
            want = min(V, head // (2 * nb), max_head_rows(nb))
            assert rows == [want], (rows, want)
            np.testing.assert_allclose(got.evalues, held.evalues, rtol=1e-4)
            note = (f"head {head} bytes, {want} head rows against the full "
                    f"head's {full_rows[0]}; eigenvalues max rel diff to "
                    f"the full head's "
                    f"{np.abs(got.evalues / held.evalues - 1).max():.2e}")
        elif outcome == "slabs kept, no head":
            assert keep and head == 0 and not rows
            assert "hybrid layout" not in per
            assert_same_run(got, st, label)
            note = "no hybrid layout; the COO wire run's results (S1's)"
        else:
            assert not keep and head == cfg_head and rows == full_rows
            assert got.loader.fill_count == 2
            assert_same_run(got, held, label)
            note = ("two fills; the held run's results "
                    f"({got.loader.fill_seconds:.4f} s of fills)")
            released = got
        if outcome != "slabs released":
            assert got.loader.fill_count == 1
        print(f"{label}: {outcome}, hbm_bytes {hbm}, slabs {slab} bytes, "
              f"nnz(B) {B.nnz} ({note})")
        del got
    del held

    # a real out-of-memory error in the middle with the slabs held (the
    # default plan: held, the configured head), behind a ballast that
    # goes with the failed attempt; planned_middle retries with the slabs
    # released and the run ends where the released run ended
    label = "streamed, resident, hybrid, out of memory with the slabs held"
    with ballast_middle(OOM_FREE_BYTES) as spy:
        got, rows, _ = run(label, "_oom", head_bytes=None)
    assert spy.attempts == 2 and spy.ooms == 1, vars(spy)
    assert got.loader.fill_count == 2 and rows == full_rows * 2, rows
    assert_same_run(got, released, label)
    print(f"{label}: the first attempt raised torch.OutOfMemoryError with "
          f"{spy.free} bytes free at its start (a ballast of "
          f"{spy.ballast_bytes} bytes) after {spy.alloc[0]} bytes; the retry "
          f"with the slabs released ({slab} bytes) took {spy.alloc[1]} "
          f"bytes above its start (eigenpairs reused: {spy.reused[1]}); two "
          f"fills; equal to the released run bit for bit (its printed peak "
          f"counts from the retry's start)")
    del got, released

    # the sharded streamed trainer on the resident loader against S5's
    label = f"sharded streamed, resident, world size {mesh.world}"
    rs = streamed_trainer(corpus, shape, seed, os.path.join(out, "nyt_Rms"),
                          mesh=mesh, resident_bytes=None)
    with no_library_spmm():
        wall, peak, launches[label], per = run_streamed(rs)
    print_streamed_run(label, rs, wall, peak, launches[label])
    check_streamed_launches(per, chunks, label)
    assert isinstance(rs.loader, streaming.ResidentLoader)
    assert rs.loader.fill_count == 1
    assert list(per)[0] == "sharded resident corpus fill", list(per)
    assert_same_run(rs, ms, label)
    print(f"{label}: equal to S5's bit for bit; {rs.run_bytes_copied} bytes "
          f"copied against S5's {ms.run_bytes_copied}")
    print(f"phase R: {time.perf_counter() - t0:.1f} s; {card_line()}")
    return launches


# ---------------------------------------------------------------------------
# Phase Z: the corpus whose ζ thresholds bite (synth.bite_counts) at the
# NYTimes shape
# ---------------------------------------------------------------------------

BITE_COUNTS_SEED = 1
# isle_tpu's results on the bite corpus at the NYTimes shape (corpus seed
# 0, counts seed BITE_COUNTS_SEED, k = 100), made on the CPU with
# isle_tpu's own functions: ζ by isle_tpu.thresholds.compute_thresholds_np
# (the sha256 of its float32 bytes, the words with a finite ζ above 1,
# the largest finite ζ, the words at ζ = +inf) and the post-threshold nnz
# it returns; B's docs and original_cols (the sha256 of the int32 array)
# by isle_tpu.bmatrix.threshold_and_copy on isle_tpu's DocSparse.
# tests/test_torch_bite.py holds them against isle_tpu again.
_IDENTITY_COLS = \
    "552a438886f75fd5e70ff6ad0671698758af0a126388ab130f4eb85c0cf6c725"
BITE_PINS = {
    "default": dict(
        zeta_sha256="5fd05fbdee069dcfd66c11056ae2f50e"
                    "086232afc24dc8d2cd9addb8ecc51c35",
        zeta_above_1=130, zeta_max=708.0, zeta_inf=0, nnz_b=38_008_938,
        docs_b=300_000, original_cols_sha256=_IDENTITY_COLS),
    "few_samples_threshold_drop": dict(
        zeta_sha256="ae2ecea094853035955fadb8c11d8479"
                    "6cf5303ed55e3c583f4fcd786bec6d1e",
        zeta_above_1=130, zeta_max=708.0, zeta_inf=98_363,
        nnz_b=13_857_375, docs_b=300_000,
        original_cols_sha256=_IDENTITY_COLS),
    "bad_threshold_drop": dict(
        zeta_sha256="79f4a51e8968da4977e041ffcc45e1c0"
                    "944aff4b68f90dba2d2e0c3b7b20c244",
        zeta_above_1=130, zeta_max=708.0, zeta_inf=4_166, nnz_b=24_352_295,
        docs_b=300_000, original_cols_sha256=_IDENTITY_COLS),
}
# Z6: phase 7's training options at full width on the default eigensolver,
# and Lanczos
BITE_OPTIONS = dict(OPTIONS, lanczos=dict(hyper=dict(eigensolver="lanczos")))
# Z6: Elkan's from the draws of Z1's Lloyd's, the share of docs on the
# same cluster
ELKANS_AGREEMENT = 0.999


def sha256(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def threshold_pins(z: np.ndarray, nnz_b: int, cols: np.ndarray) -> dict:
    """A run's ζ, nnz(B) and original_cols in BITE_PINS's terms."""
    fin = np.isfinite(z)
    return dict(zeta_sha256=sha256(z), zeta_above_1=int((z[fin] > 1).sum()),
                zeta_max=float(z[fin].max()), zeta_inf=int((~fin).sum()),
                nnz_b=int(nnz_b), docs_b=len(cols),
                original_cols_sha256=sha256(np.asarray(cols, np.int32)))


def check_pins(label: str, flag: str, got: dict, full: bool) -> None:
    """`got` (threshold_pins) equal to isle_tpu's pinned results at the
    full shape; at a cut corpus printed only, on a CUT line."""
    want = BITE_PINS[flag]
    bad = {key: (got[key], want[key]) for key in want if got[key] != want[key]}
    assert not (full and bad), \
        f"{label}: differs from isle_tpu's pinned results in {bad}"
    print(("" if full else "CUT: ") + f"{label}: ζ sha256 "
          f"{got['zeta_sha256'][:16]}, {got['zeta_above_1']} words with ζ > 1 "
          f"(largest {got['zeta_max']:g}), {got['zeta_inf']} at +inf, nnz(B) "
          f"{got['nnz_b']}, {got['docs_b']} docs in B (original_cols sha256 "
          f"{got['original_cols_sha256'][:16]}): "
          + ("equal to isle_tpu's pinned results" if full else
             "isle_tpu's pins are for the full shape, not checked"))


def check_result(tr, shape: dict, label: str) -> str:
    """Every model column sums (in float64) to 1 within 1e-5 or is all
    zero, the models are finite, the eigenvalues finite and descending, at
    least one catchword. Returns a line of the result."""
    model = tr.model
    assert model.shape == (shape["vocab"], shape["k"]), label
    assert np.isfinite(model).all() and np.isfinite(tr.edge_model).all(), \
        label
    # summed in float64: a float32 sum of 102,660 entries drifts by ~1e-5
    sums = model.sum(axis=0, dtype=np.float64)
    zero = ~model.any(axis=0)
    assert np.all(zero | (np.abs(sums - 1.0) <= 1e-5)), (label, sums)
    ev = np.asarray(tr.evalues)
    assert np.isfinite(ev).all() and np.all(np.diff(ev) <= 0), (label, ev)
    n_cw = sum(len(c) for c in tr.catchwords)
    assert n_cw > 0, f"{label}: no catchwords"
    return (f"{n_cw} catchwords, {tr.edge_model.shape[1]} edge topics, "
            f"{int(zero.sum())} empty topics, lambda_1 {ev[0]:.6g}, "
            f"lambda_k {ev[-1]:.6g}")


def timed_train(corpus, shape, seed, out, label, stages=False, **kw):
    """train() with the launch counts set to 0 just before and read just
    after: prints the wall, the peak and the launches (and with `stages`
    each stage's wall). Returns (the trainer, SimpleNamespace(wall, peak,
    held, launches, per))."""
    from isle_tpu_torch import segsum

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    segsum.reset_launch_counts()
    t0 = time.perf_counter()
    tr = train(corpus, shape, seed, "cuda", out, **kw)
    torch.cuda.synchronize()
    r = SimpleNamespace(wall=time.perf_counter() - t0, held=held,
                        peak=torch.cuda.max_memory_allocated() / 2**30,
                        launches=segsum.launch_counts(),
                        per=stage_launches(tr))
    print(f"{label}: train + edge topics {r.wall:.2f} s wall, peak device "
          f"memory {r.peak:.2f} GiB ({held:.2f} GiB held before the run), "
          f"kernel launches {r.launches}")
    if stages:
        for stage, w, _ in tr.timer.phases:
            print(f"  {label} stage {stage}: {w:.3f} s")
    return tr, r


def agreement(a, b) -> tuple:
    """(share of docs in both runs' B on the same cluster, the share up to
    the clusters' labels), over the docs both runs clustered."""
    both = (a.cluster_of_doc >= 0) & (b.cluster_of_doc >= 0)
    x, y = a.cluster_of_doc[both], b.cluster_of_doc[both]
    k = int(max(x.max(), y.max())) + 1
    return float((x == y).mean()), clusters_up_to_labels(x, y, k)


def bite_corpus(entries, shape: dict):
    """The bite corpus: phase 4's (doc, word) pairs with the counts of
    synth.bite_counts. Returns (its entries, its Corpus)."""
    from isle_tpu_torch import thresholds
    from isle_tpu_torch.synth import bite_counts

    d, w, _ = entries
    t0 = time.perf_counter()
    c = bite_counts(d, BITE_COUNTS_SEED)
    t1 = time.perf_counter()
    corpus = make_corpus((d, w, c), shape)
    F = thresholds.freq_bound(corpus.avg_doc_sz)
    print(f"bite corpus: counts redrawn by synth.bite_counts (seed "
          f"{BITE_COUNTS_SEED}, largest {int(c.max())}) in {t1 - t0:.1f} s, "
          f"corpus built in {time.perf_counter() - t1:.1f} s (host); nnz "
          f"{corpus.nnz}, avg_doc_sz {corpus.avg_doc_sz:g}, ζ histogram "
          f"{corpus.vocab_size + 1} x {F + 1} ({onehot_window(F + 1)})")
    return (d, w, c), corpus


def bite_in_core(corpus, shape, seed, out, full) -> tuple:
    """Phase Z1: the bite corpus in core (COO). Returns (the trainer, its
    run, B on the card, the kernel uses at this corpus's shapes)."""
    from isle_tpu_torch import bmatrix
    from isle_tpu_torch.sparse import DocSparse

    label = "phase Z1, bite corpus, in core (COO)"
    tr, run = timed_train(corpus, shape, seed, os.path.join(out, "bite"),
                          label, stages=True)
    svd = run_dir_arrays(tr, "svd")
    z = torch.from_numpy(svd["zetas"]).cuda()
    B, cols = bmatrix.threshold_and_copy(tr.A, z)
    assert np.array_equal(cols, tr.original_cols)
    assert np.array_equal(cols, svd["original_cols"])
    # the same stage on the CPU (the plain path) on a host copy of A
    t0 = time.perf_counter()
    A = tr.A
    host = DocSparse(**{f: getattr(A, f).cpu() for f in B_FIELDS},
                     vocab=A.vocab, num_docs=A.num_docs)
    HB, host_cols = bmatrix.threshold_and_copy(host, z.cpu())
    assert np.array_equal(host_cols, cols), "Z1: original_cols on the CPU"
    for f in B_FIELDS:
        assert torch.equal(getattr(HB, f), getattr(B, f).cpu()), f"Z1: B.{f}"
    cpu_s = time.perf_counter() - t0
    del host, HB
    check_pins(label, "default", threshold_pins(svd["zetas"], B.nnz, cols),
               full)
    print(f"{label}: B ({B.nnz} nnz, {B.num_docs} docs, {A.nnz - B.nnz} "
          f"entries dropped) equals threshold_and_copy on the CPU "
          f"({cpu_s:.1f} s with the copy); result: "
          f"{check_result(tr, shape, label)}")

    uses = compare_kernels(tr, run.launches, seed)
    need = sum(u["launches"] for u in uses[ONEHOT])
    assert run.launches[ONEHOT] >= need, (label, run.launches, need)
    need = gather_calls(uses)
    assert run.launches[GATHER] >= need, (label, run.launches, need)
    for rows in uses.values():
        for u in rows:
            u["use"] = "bite corpus, " + u["use"]
    print_uses(uses, "bite corpus's in-core path")
    print(f"{label}: segsum_gather_rows {run.launches[GATHER]} launches for "
          f"{need} SpMM calls ({tr.op_counter.calls} eigensolver operator "
          f"calls, {lloyds_reps(tr)} full-space Lloyd's iterations); "
          f"{card_line()}")
    tr.A = None
    return tr, run, B, uses


def bite_option(corpus, shape, seed, out, z1, label, path, **kw) -> tuple:
    """One in-core run of the bite corpus beside Z1: it finishes, its
    result holds (check_result), each kernel launched at least once a use
    (the ζ histogram, the group counts, the doc-topic mass, Frob(B); two
    products an operator call, the projection, the model). Returns (the
    trainer, its run)."""
    tr, run = timed_train(corpus, shape, seed, os.path.join(out, path),
                          label, **kw)
    want = (4, 2 * tr.op_counter.calls + 2)
    got = (run.launches[ONEHOT], run.launches[GATHER])
    assert got[0] >= want[0] and got[1] >= want[1], (label, got, want)
    same, relabeled = agreement(tr, z1)
    print(f"{label}: {len(tr.original_cols)} docs in B; result: "
          f"{check_result(tr, shape, label)}; clusters equal Z1's on "
          f"{same:.4%} of docs ({relabeled:.4%} up to labels)")
    tr.A = None
    return tr, run


def bite_phase(entries, shape, seed, out, mesh) -> tuple:
    """Phase Z: the bite corpus (synth.bite_counts over phase 4's pairs).
    Returns ({kernel: its uses at this corpus's shapes}, {path: launch
    counts})."""
    from isle_tpu_torch import bmatrix, streaming

    t_phase = time.perf_counter()
    full = shape == NYT and seed == 0
    launches = {}
    bite_entries, corpus = bite_corpus(entries, shape)

    # Z1: in core, COO
    z1, run, B, uses = bite_in_core(corpus, shape, seed, out, full)
    launches["bite, in-core"], z1_per = run.launches, run.per

    # Z2: the default hybrid layout
    label = "phase Z2, bite corpus, hybrid (GpuConfig's default)"
    hy, run = timed_train(corpus, shape, seed, os.path.join(out, "bite_h"),
                          label, stages=True, head_bytes=None)
    launches["bite, in-core, hybrid"] = run.launches
    ours, ref = run_dir_arrays(hy, "svd"), run_dir_arrays(z1, "svd")
    for key in ("zetas", "original_cols"):
        assert np.array_equal(ours[key], ref[key]), f"{label}: {key}"
    np.testing.assert_allclose(hy.evalues, z1.evalues, rtol=1e-4)
    same, relabeled = agreement(hy, z1)
    print(f"{label}: zetas and original_cols equal Z1's, eigenvalues max rel "
          f"diff {np.abs(hy.evalues / z1.evalues - 1).max():.2e}; clusters "
          f"equal Z1's on {same:.4%} of docs ({relabeled:.4%} up to labels); "
          f"result: {check_result(hy, shape, label)}")
    hy.A = None
    del hy

    # Z5: the drop flags, each alone
    for flag in ("few_samples_threshold_drop", "bad_threshold_drop"):
        label = f"phase Z5, bite corpus, {flag}"
        tr, run = timed_train(corpus, shape, seed,
                              os.path.join(out, f"bite_{flag}"), label,
                              hyper={flag: True})
        launches[f"bite, {flag}"] = run.launches
        z = run_dir_arrays(tr, "svd")["zetas"]
        FB, cols = bmatrix.threshold_and_copy(tr.A, torch.from_numpy(z).cuda())
        assert np.array_equal(cols, tr.original_cols), label
        check_pins(label, flag, threshold_pins(z, FB.nnz, cols), full)
        print(f"{label}: result: {check_result(tr, shape, label)}")
        tr.A = None
        del tr, FB

    # Z6: the training options and Lanczos, in core on the default solver
    sampled = None
    for name, opts in BITE_OPTIONS.items():
        label = f"phase Z6, bite corpus, {name}"
        tag = name.replace(" ", "_").replace("=", "_")
        tr, run = bite_option(corpus, shape, seed, out, z1, label,
                              f"bite_{tag}", **opts)
        launches[f"bite, {name}"] = run.launches
        if name == "elkans":
            nb, k = len(tr.original_cols), shape["k"]
            same, _ = agreement(tr, z1)
            print(f"{label}: bound arrays {4 * nb * k + 4 * nb} bytes (lower "
                  f"bounds {nb} x {k} and upper bounds {nb}, float32), peak "
                  f"{run.peak:.2f} GiB against Z1's Lloyd's on {same:.4%} of "
                  f"docs (gate {ELKANS_AGREEMENT:.1%})")
            assert same >= ELKANS_AGREEMENT, \
                f"{label}: agrees with Lloyd's on {same:.4%} of docs only"
        elif name.startswith("use_explicit_projected_matrix"):
            assert_same_run(tr, z1, label)  # the same product in the port
        elif name.startswith("sample_docs"):
            sampled = tr
        del tr
    assert sampled is not None

    # Z4: the sharded trainer over the one-rank mesh, against Z1
    sh, launches["bite, sharded"], _ = sharded_phase(
        corpus, shape, seed, out, z1, mesh, z1_per,
        name="bite_m", label="phase Z4, bite corpus, sharded")
    del sh

    # Z3: out of core, on the wire and the resident loader
    z = torch.from_numpy(run_dir_arrays(z1, "svd")["zetas"]).cuda()
    runs = {}
    for name, resident in (("wire", 0), ("resident", None)):
        label = f"phase Z3, bite corpus, streamed, {name}"
        st = streamed_trainer(corpus, shape, seed,
                              os.path.join(out, f"bite_s_{name}"),
                              resident_bytes=resident)
        wall, peak, launches[f"bite, streamed, {name}"], per = \
            run_streamed(st)
        print_streamed_run(label, st, wall, peak,
                           launches[f"bite, streamed, {name}"])
        loader = st.loader
        check_streamed_launches(per, len(loader.ranges), label)
        SB, cols = streaming.streamed_build_b(corpus, z, None, loader)
        assert np.array_equal(cols, z1.original_cols), label
        assert_same_b(SB, B)
        del SB
        if resident is None:
            assert isinstance(loader, streaming.ResidentLoader), label
            assert loader.count_dtype == np.uint16, loader.count_dtype
            assert loader.fill_count == 1
            vals, off = torch.from_numpy(corpus.vals), corpus.offsets
            for lo, hi, _, v, _ in loader.chunks():
                want = vals[int(off[lo]):int(off[hi])].cuda()
                assert torch.equal(v.view(torch.int32),
                                   want.view(torch.int32)), \
                    f"{label}: the values of docs [{lo}, {hi})"
            assert_same_run(st, runs["wire"], label)
        ours = run_dir_arrays(st, "svd")
        assert np.array_equal(ours["zetas"], run_dir_arrays(z1, "svd")[
            "zetas"]), label
        np.testing.assert_allclose(st.evalues, z1.evalues, rtol=1e-4)
        np.testing.assert_allclose(st.model, z1.model, rtol=0, atol=1e-6)
        print(f"{label}: zetas, original_cols and B equal Z1's"
              + (" (counts kept as uint16, every chunk's values equal "
                 "corpus.vals; bit-equal to the wire run)"
                 if resident is None else "")
              + f"; eigenvalues max rel diff "
              f"{np.abs(st.evalues / z1.evalues - 1).max():.2e}, model max "
              f"abs diff {np.abs(st.model - z1.model).max():.3e} (clusters "
              f"equal Z1's: {np.array_equal(st.cluster_of_doc, z1.cluster_of_doc)})")
        runs[name] = st
    del runs, st, loader
    # the sampled pair against the in-core stage and the in-core run
    wire = None
    for name, resident in (("wire", 0), ("resident", None)):
        label = f"phase Z3, bite corpus, streamed, {name}"
        launches[f"bite, streamed, {name}, sampled"], _, st = \
            streamed_sampling_phase(corpus, shape, seed, out, z1,
                                    name=f"bite_ss_{name}", label=label,
                                    resident_bytes=resident)
        if resident is None:
            assert isinstance(st.loader, streaming.ResidentLoader), label
            assert st.loader.count_dtype == np.uint16
            assert_same_run(st, wire, label + ", sampled")
        else:
            wire = st
        assert np.array_equal(st.original_cols, sampled.original_cols), \
            f"{label}, sampled: original_cols differ from Z6's in-core run"
        np.testing.assert_allclose(st.evalues, sampled.evalues, rtol=1e-4)
        np.testing.assert_allclose(st.model, sampled.model, rtol=0,
                                   atol=1e-6)
        print(f"{label}, sampled: original_cols ({len(st.original_cols)} "
              f"docs) equal the in-core sampled run's (Z6), eigenvalues max "
              f"rel diff {np.abs(st.evalues / sampled.evalues - 1).max():.2e},"
              f" model max abs diff "
              f"{np.abs(st.model - sampled.model).max():.3e}")
    del st, wire, sampled, B
    torch.cuda.empty_cache()

    # Z7: inference over the bite corpus with Z1's model
    infer_full(z1, bite_entries, shape, seed, out,
               label="phase Z7, bite corpus inference", top_equal=True,
               name="infer_bite")
    print(f"phase Z: {time.perf_counter() - t_phase:.1f} s; {card_line()}")
    return uses, launches


def float64_segment_sum(seg, g, num_segments) -> torch.Tensor:
    """(num_segments, W) float64 sums of g's rows by segment, a slice of
    2^21 entries at a time (the reference the modes are held to)."""
    out = torch.zeros((num_segments, g.shape[1]), dtype=torch.float64,
                      device=g.device)
    for a in range(0, seg.numel(), 1 << 21):
        out.index_add_(0, seg[a:a + (1 << 21)], g[a:a + (1 << 21)].double())
    return out


def micro_streams_check(seed: int, timed: dict) -> list:
    """Phase M's checks of chunk_partials, after the drive: per stream the
    plan equal to its host version exactly; per mode the kernel within
    maxrel 1e-6 of its plain version, two launches bit-equal, the rows at
    unused ranks exactly zero, and the partials plus the scatter against
    the float64 sums (highest within 1e-6, split2 within 1e-5). Returns
    the uses."""
    from isle_tpu_torch import micro_kernels as mk
    from isle_tpu_torch.benchmarks import maxrel, micro_pallas as bp, min_ms

    n, W, C = MICRO["n"], MICRO["width"], MICRO["chunk"]
    rows = []
    for label, avg_run, segments in bp.STREAMS:
        nseg = segments(n)
        seg, g = bp.stream_inputs(n, W, avg_run, nseg, seed, "cuda")
        res = timed[label]
        rank2d, ids, rcap = mk.plan_ranks(seg, C)
        t0 = time.perf_counter()
        r_h, i_h, c_h = mk.plan_ranks_plain(seg.cpu().numpy(), C)
        plan_host_s = time.perf_counter() - t0
        assert c_h == rcap == res["rcap"], (c_h, rcap)
        assert np.array_equal(rank2d.cpu().numpy(), r_h), "plan: rank2d"
        assert np.array_equal(ids.cpu().numpy(), i_h), "plan: ids"
        rank, nchunks = rank2d.view(-1), n // C
        used = torch.zeros(nchunks * rcap, dtype=torch.bool, device="cuda")
        used[(torch.arange(n, device="cuda") // C) * rcap + rank] = True
        used = used.view(nchunks, rcap)
        ref = float64_segment_sum(seg, g, nseg)
        part_bytes = n * W * 4 + n * 4 + nchunks * rcap * W * 4
        scatter_bound = (nchunks * rcap * (W * 4 + 4) + nseg * W * 4) \
            / HBM_BYTES_PER_S * 1e3
        print(f"[{label}] plan equal to its host version (rcap {rcap}, "
              f"{int(used.sum())} of {nchunks * rcap} rank slots used; host "
              f"plan {plan_host_s:.2f} s)")
        for mode in mk.MODES:
            part = mk.chunk_partials(rank, g, C, rcap, mode)
            plain_ms = min_ms(lambda: mk.chunk_partials_plain(
                rank, g, C, rcap, mode))
            plain = mk.chunk_partials_plain(rank, g, C, rcap, mode)
            err = maxrel(part, plain)
            abs_err = float((part - plain).abs().max())
            del plain
            bit_equal = torch.equal(part, mk.chunk_partials(rank, g, C, rcap,
                                                            mode))
            zero = not part[~used].any()
            err64 = maxrel(mk.scatter_partials(part, ids, nseg), ref)
            del part
            passes = {"highest": 0, "split2": 2, "default": 1}[mode]
            if passes:  # the dense one-hot product, bf16 on the tensor cores
                bound_ms, bound_by = bound(part_bytes,
                                           passes * 2 * rcap * W * n,
                                           BF16_FLOPS)
            else:  # n W float32 adds
                bound_ms, bound_by = bound(part_bytes, n * W)
            r = res[mode]
            info = mk.kernel_info(mode, n, W, C, rcap)
            print(f"[{label}] {mode:7s}: plan {res['plan']:.3f} ms, partials "
                  f"kernel {r['kernel']:.3f} ms ({bound_ms / r['kernel']:.0%} "
                  f"of the bound, {res['index_add'] / r['kernel']:.2f}x "
                  f"index_add_; {info['threads']} threads, "
                  f"{info['smem_bytes']} B shared, {info['registers']} "
                  f"registers, {info['blocks_per_sm']} blocks/SM), partials "
                  f"+ scatter "
                  f"{r['with_scatter']:.3f} ms, index_add_ "
                  f"{res['index_add']:.3f} ms, segsum_gather_rows(arange) "
                  f"{res['arange']:.3f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms:.3f} ms ({bound_by}; the scatter "
                  f"{scatter_bound:.3f} ms more); maxrelerr to plain "
                  f"{err:.2e}, to float64 {err64:.2e}, to index_add_ "
                  f"{r['maxrelerr']:.2e}; two launches bit-equal "
                  f"{bit_equal}, unused ranks zero {zero}")
            assert err <= 1e-6, (label, mode, "plain", err)
            assert bit_equal and zero, (label, mode, bit_equal, zero)
            if mode in ("highest", "split2"):
                tol = 1e-6 if mode == "highest" else 1e-5
                assert err64 <= tol, (label, mode, "float64", err64)
            rows.append(dict(
                use=f"{label.split()[0]} {mode}", launches=r["launches"],
                max_abs_err=abs_err, ms=r["kernel"], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=res["index_add"], rcap=rcap,
                with_scatter_ms=r["with_scatter"],
                scatter_bound_ms=scatter_bound, arange_ms=res["arange"],
                plan_ms=res["plan"], maxrelerr_plain=err,
                maxrelerr_float64=err64))
        del seg, g, ref, used, rank2d, ids, rank
        torch.cuda.empty_cache()
    return rows


def micro_gather_check(seed: int, timed: dict) -> list:
    """Phase M's checks of row_gather_async, after the drive: at every
    (chunk, depth) bit-equal to index_select, twice. Returns the uses."""
    from isle_tpu_torch import micro_kernels as mk
    from isle_tpu_torch.benchmarks import micro_pallas_gather as bg, min_ms

    n, V, W = MICRO["gather_n"], MICRO["gather_rows"], MICRO["width"]
    idx, tab = bg.gather_inputs(n, V, W, seed, "cuda")
    base = torch.index_select(tab, 0, idx)
    plain_ms = min_ms(lambda: mk.row_gather_plain(idx, tab))
    bound_ms, bound_by = bound(n * 4 + V * W * 4 + n * W * 4, 0)
    hbm_ms = (n * 4 + 2 * n * W * 4) / HBM_BYTES_PER_S * 1e3
    rows = []
    for chunk, depth in bg.SWEEP:
        r = timed[chunk, depth]
        exact = [torch.equal(mk.row_gather_async(idx, tab, chunk, depth),
                             base) for _ in range(2)]
        info = mk.kernel_info("gather", n, W, chunk, depth)
        print(f"row gather C={chunk} depth={depth}: {r['ms']:.3f} ms "
              f"({n / r['ms'] / 1e3:.1f} Mrows/s; {bound_ms / r['ms']:.0%} "
              f"of the bound, {timed['index_select'] / r['ms']:.2f}x "
              f"index_select; {info['smem_bytes']} B shared, "
              f"{info['registers']} registers, {info['blocks_per_sm']} "
              f"blocks/SM), exact={r['exact']} (and "
              f"{exact} again), index_select {timed['index_select']:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
              f"({bound_by}; every row from HBM {hbm_ms:.3f} ms)")
        assert r["exact"] and all(exact), (chunk, depth)
        rows.append(dict(use=f"C={chunk} depth={depth}",
                         launches=r["launches"], max_abs_err=0.0, ms=r["ms"],
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by,
                         library_ms=timed["index_select"]))
    del idx, tab, base
    torch.cuda.empty_cache()
    return rows


def micro_phase(seed: int) -> tuple:
    """Phase M: the two micro-benchmark drivers' work
    (isle_tpu_torch/benchmarks/micro_pallas.py and micro_pallas_gather.py)
    at their full shapes, with every launch count reset just before and
    read just after, then each kernel held against its plain version, a
    float64 sum and the library. Returns ({kernel: uses}, the drive's
    launch counts)."""
    from isle_tpu_torch import micro_kernels as mk, segsum
    from isle_tpu_torch.benchmarks import micro_pallas as bp, \
        micro_pallas_gather as bg

    n, W, C = MICRO["n"], MICRO["width"], MICRO["chunk"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launch_counts()
    segsum.reset_launch_counts()
    t0 = time.perf_counter()
    timed = {}
    for label, avg_run, segments in bp.STREAMS:
        nseg = segments(n)
        seg, g = bp.stream_inputs(n, W, avg_run, nseg, seed, "cuda")
        timed[label] = bp.run_stream(label, seg, g, nseg, C)
        del seg, g
        torch.cuda.empty_cache()
    idx, tab = bg.gather_inputs(MICRO["gather_n"], MICRO["gather_rows"], W,
                                seed, "cuda")
    gathered = bg.run_sweep(idx, tab)
    del idx, tab
    torch.cuda.synchronize()
    launches = {**segsum.launch_counts(), **mk.launch_counts()}
    print(f"micro path (both drivers; n {n}, W {W}, chunk {C}; gather n "
          f"{MICRO['gather_n']} of {MICRO['gather_rows']} rows): "
          f"{time.perf_counter() - t0:.1f} s wall, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, kernel "
          f"launches {launches}; {card_line()}")
    uses = {PARTIALS: micro_streams_check(seed, timed),
            ROWGATHER: micro_gather_check(seed, gathered)}
    for name, rows in uses.items():
        need = sum(u["launches"] for u in rows)
        assert launches[name] == need > 0, (name, launches[name], need)
    torch.cuda.empty_cache()
    return uses, launches


# ---------------------------------------------------------------------------
# Phase C: the ISLETrain and ISLEInfer CLIs at the NYTimes shape
# ---------------------------------------------------------------------------

# the text files of an ISLETrain run directory that carry its results
CLI_RESULT_FILES = ("M_hat_catch_sparse", "TopWordsPerTopic_catch.txt",
                    "DocCatchword.tsv", "DocTopicCatchwordSums.tsv",
                    "EdgeModel_sparse", "EdgeTopicComposition.txt",
                    "TopTwoTopicsPerDoc.txt")
# the run directory's logs: the timings, and the diagnostics (which name
# the run's paths); neither is compared
CLI_LOGS = ("timerLog.txt", "diagnosticLog.txt")
CLI_LIMIT_S = 900  # a CLI process's time limit
TIMER_LINE = re.compile(r"^Time for (.+): [0-9.]+s user, ([0-9.]+)s wall$",
                        re.M)


def run_cli(module: str, args: list, log_path: str) -> SimpleNamespace:
    """`python -m module args` in a process of its own from the checkout's
    root, its output (stdout and stderr) into log_path: its exit code,
    the wall from launch to exit and its output. A process past
    CLI_LIMIT_S is killed and fails the phase."""
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        rc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                            stdout=log, stderr=subprocess.STDOUT,
                            timeout=CLI_LIMIT_S).returncode
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        return SimpleNamespace(rc=rc, wall=wall, log=f.read())


def log_line(log: str, prefix: str) -> str:
    """The first line of `log` that starts with `prefix`, the prefix cut
    off."""
    for line in log.splitlines():
        if line.startswith(prefix):
            return line[len(prefix):]
    raise AssertionError(f"no line starting with {prefix!r} in the log")


def check_cli_run(tool: str, run: SimpleNamespace) -> str:
    """The gates every CLI run shares: exit code 0, and a start line that
    names the card and the native text I/O. Returns the run's line of
    wall, peak RSS and peak device memory (its last log line)."""
    assert run.rc == 0, f"{tool} exited {run.rc}:\n{run.log[-6000:]}"
    start = log_line(run.log, f"{tool} on ")
    assert start.startswith("cuda") and start.endswith("text I/O native"), \
        f"{tool} ran on {start!r}"
    peaks = log_line(run.log, f"{tool} done, ")
    return (f"{tool} on {start}: rc 0, {run.wall:.2f} s from launch to "
            f"exit, its own {peaks}")


def print_cli_stages(tool: str, log: str) -> None:
    for stage, wall in TIMER_LINE.findall(log):
        print(f"  {tool} stage {stage}: {float(wall):.3f} s")
    print(f"  {tool} total: {log_line(log, f'Total time for {tool}: ')}")


def file_lines(path: str, workers: int = 8) -> tuple:
    """(bytes, lines) of a file, its byte ranges read and counted by
    `workers` threads at once."""
    size = os.path.getsize(path)

    def count(lo: int) -> int:
        hi, n = min(lo + step, size), 0
        with open(path, "rb") as f:
            f.seek(lo)
            while lo < hi and (chunk := f.read(min(1 << 24, hi - lo))):
                n += chunk.count(b"\n")
                lo += len(chunk)
        return n

    step = max(-(-size // workers), 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return size, sum(pool.map(count, range(0, size, step)))


def write_like_cli(tr, run_dir: str, vocab_words) -> SimpleNamespace:
    """The writers cli/train.py calls after training, in its order, run on
    the trainer `tr` into `run_dir` with `vocab_words`: returns the
    cluster summary's info and diagnostic messages and the writers'
    seconds."""
    saved = tr.run_dir, tr.vocab_words
    summary = SimpleNamespace(info=[], diag=[])
    sinks = {"info": summary.info.append, "diagnostic": summary.diag.append}
    tr.run_dir, tr.vocab_words = run_dir, vocab_words
    os.makedirs(run_dir, exist_ok=True)
    tr.timer.next("(before the writers)")
    first = len(tr.timer.phases)
    try:
        for channel, fn in sinks.items():
            tr.logger.add_sink(channel, fn)
        try:
            tr.output_cluster_summary()
        finally:
            for channel, fn in sinks.items():
                tr.logger.sinks[channel].remove(fn)
        tr.write_model_to_file()
        tr.output_doc_topic()
        tr.output_topic_diversity()
        if tr.config.compute_edge_topics:
            tr.write_edgemodel_to_file()
            tr.print_top_two_topics()
    finally:
        tr.run_dir, tr.vocab_words = saved
        tr.A = None
        torch.cuda.empty_cache()
    summary.seconds = tr.timer.phases[first:]
    return summary


def messages(msgs: list) -> str:
    """Logger messages as the logger writes them, a newline after each."""
    return "".join(m if m.endswith("\n") else m + "\n" for m in msgs)


def read_report(path: str) -> np.ndarray:
    """A top-topics report as (lines, 3) float64: doc, topic, weight."""
    with open(path, "rb") as f:
        return np.array(f.read().split(), dtype=np.float64).reshape(-1, 3)


def compare_reports(got_path: str, ref_path: str, k: int) -> str:
    """Two top-topics reports that are not byte-equal: the same (doc,
    topic) lines but where a weight lies within 1e-6 of its doc's
    smallest listed weight on the other side or of the 1/k cut (a tie
    that decides the listing), and the common lines' weights within 1e-4.
    Returns how they differ."""
    got, ref = read_report(got_path), read_report(ref_path)

    def keyed(r):
        return r[:, 0].astype(np.int64) * (k + 1) + r[:, 1].astype(np.int64)

    kg, kr = keyed(got), keyed(ref)
    both, ig, ir = np.intersect1d(kg, kr, return_indices=True)
    err = float(np.abs(got[ig, 2] - ref[ir, 2]).max(initial=0.0))
    assert err <= 1e-4, f"report weights differ by {err}"
    for one, other, name in ((got, ref, "the CLI's"), (ref, got, "ours")):
        alone = ~np.isin(keyed(one), both)
        if not alone.any():
            continue
        docs = one[alone, 0]
        low = np.full(len(docs), np.inf)
        ud, inv = np.unique(other[:, 0], return_inverse=True)
        mins = np.full(len(ud), np.inf)
        np.minimum.at(mins, inv, other[:, 2])
        at = np.searchsorted(ud, docs)
        has = (at < len(ud)) & (ud[np.minimum(at, len(ud) - 1)] == docs)
        low[has] = mins[at[has]]
        w = one[alone, 2]
        tie = (np.abs(w - low) <= 1e-6) | (np.abs(w - 1.0 / k) <= 1e-6)
        assert tie.all(), f"{name} report lists {int((~tie).sum())} " \
            f"(doc, topic) pairs the other leaves out, not at a tie"
    order = (len(kg) == len(kr)) and bool(np.array_equal(kg, kr))
    return (f"{len(got)} lines against {len(ref)}, {len(both)} (doc, topic) "
            f"pairs in both, the same order: {order}, weights max abs diff "
            f"{err:.3e}")


def cli_phase(tr, hy, shape: dict, seed: int, out: str) -> None:
    """Phase C: ISLETrain and ISLEInfer as a user runs them, in processes
    of their own, on phase 4's corpus written as a TDF file; every file
    they write held against the port's writers run in this process."""
    from isle_tpu_torch import Corpus, GpuConfig, InferConfig, Inferencer, \
        io_text, native
    from isle_tpu_torch.cli.train import train_config
    from isle_tpu_torch.corpus import read_vocab_file
    from isle_tpu_torch.inferencer import report_name

    t_phase = time.perf_counter()
    corpus = tr.corpus
    V, D, nnz, k = corpus.vocab_size, corpus.num_docs, corpus.nnz, shape["k"]
    base = os.path.join(out, "cli")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    assert native.backend() == "native", native.backend()

    # C0: the input files
    tdf, vocab = os.path.join(base, "corpus.tdf"), os.path.join(base, "vocab")
    t0 = time.perf_counter()
    native.write_int_triples(tdf, corpus.doc_ids(), corpus.rows,
                             corpus.counts, 1, 1, 0)
    tdf_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(vocab, "w") as f:
        f.write("".join(f"word{w + 1}\n" for w in range(V)))
    vocab_s = time.perf_counter() - t0
    print(f"phase C0: the TDF file {file_lines(tdf)} (bytes, lines) written "
          f"by the port's native triple writer in {tdf_s:.2f} s, the vocab "
          f"file {file_lines(vocab)} in {vocab_s:.2f} s")

    # C1: ISLETrain
    args = [tdf, vocab, os.path.join(base, "train"), str(V), str(D), "0",
            str(k), "0", "0", "0", "1", str(shape["edges"]), "--seed",
            str(seed)]
    torch.cuda.empty_cache()
    run = run_cli("isle_tpu_torch.cli.train", args,
                  os.path.join(base, "train.log"))
    print(f"phase C1: {check_cli_run('ISLETrain', run)}")
    print_cli_stages("ISLETrain", run.log)
    t0 = time.perf_counter()
    parsed = Corpus.from_tdf_file(tdf, vocab_size=V, num_docs=D)
    parse_s = time.perf_counter() - t0
    for f in ("offsets", "rows", "counts", "vals"):
        a, b = getattr(parsed, f), getattr(corpus, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), \
            f"phase C1: the TDF file's {f} differ from phase 4's corpus"
    for f in ("vocab_size", "num_docs", "avg_doc_sz", "nz_docs"):
        assert getattr(parsed, f) == getattr(corpus, f), f
    # the in-process run of the CLI's configuration: phase H1's
    cfg, ref = train_config(args[3:12], seed), hy
    assert cfg == ref.config and GpuConfig(device="cuda") == ref.gpu, \
        (cfg, ref.config, ref.gpu)
    run_dir = os.path.join(base, "train", cfg.log_dir_name())
    for stage in ("svd", "kmeans", "model"):
        name = f"ckpt_{stage}.npz"
        with np.load(os.path.join(run_dir, name)) as a, \
                np.load(os.path.join(ref.run_dir, name)) as b:
            assert sorted(a.files) == sorted(b.files), (name, a.files)
            for key in a.files:
                assert np.array_equal(a[key], b[key]), \
                    f"phase C1: {name}[{key}] differs from phase H1's run"
            if stage == "model":
                assert np.array_equal(a["model"], ref.model)
    summary = write_like_cli(ref, os.path.join(base, "inprocess"),
                             read_vocab_file(vocab, V))
    written = sorted(n for n in os.listdir(run_dir)
                     if not n.endswith(".npz") and n not in CLI_LOGS)
    assert written == sorted(CLI_RESULT_FILES), written
    for name in CLI_RESULT_FILES:
        assert filecmp.cmp(os.path.join(run_dir, name),
                           os.path.join(base, "inprocess", name),
                           shallow=False), \
            f"phase C1: {name} differs from the in-process writers'"
    assert messages(summary.info) in run.log, "the cluster summary differs"
    with open(os.path.join(run_dir, "diagnosticLog.txt")) as f:
        assert messages(summary.diag) in f.read(), \
            "the cluster summary's catchword lines differ"
    print(f"phase C1: Corpus.from_tdf_file of the TDF file in this process "
          f"({parse_s:.2f} s) equals phase 4's corpus (offsets, rows, counts, "
          f"vals, avg_doc_sz, nz_docs); ckpt_svd, ckpt_kmeans and "
          f"ckpt_model.npz equal phase H1's run of the same configuration bit "
          f"for bit; the cluster summary "
          f"({len(summary.info)} info and {len(summary.diag)} diagnostic "
          f"messages) and every result file equal the in-process writers' "
          f"byte for byte: " + "; ".join(
              f"{n} {file_lines(os.path.join(run_dir, n))}"
              for n in CLI_RESULT_FILES))
    print("phase C1, the in-process writers: " + ", ".join(
        f"{label} {w:.3f} s" for label, w, _ in summary.seconds))
    print("phase C3: the CLI logs no kernel launch counts; its checkpoints "
          "are bit-equal to the in-process run, whose launches phase H1 "
          "gates")

    # C2: ISLEInfer on the written model
    model_file = os.path.join(run_dir, "M_hat_catch_sparse")
    args = [model_file, tdf, os.path.join(base, "infer"), str(k), str(V),
            "1", str(D + 1), str(nnz), "0", "0", "0"]
    torch.cuda.empty_cache()
    irun = run_cli("isle_tpu_torch.cli.infer", args,
                   os.path.join(base, "infer.log"))
    print(f"phase C2: {check_cli_run('ISLEInfer', irun)}")
    print_cli_stages("ISLEInfer", irun.log)
    icfg = InferConfig(num_topics=k, vocab_size=V)
    name = report_name(icfg, 1, D + 1)
    report = os.path.join(base, "infer", name)
    assert os.path.exists(report), f"phase C2: no report {name}"
    t0 = time.perf_counter()
    inf = Inferencer(icfg, model_file=model_file,
                     output_dir=os.path.join(base, "infer_ref"), quiet=True,
                     gpu=GpuConfig(device="cuda"))
    load_s = time.perf_counter() - t0
    res = inf.infer_corpus(parsed.normalized_to_one(), top_n=5,
                           max_entries=nnz)
    ours = os.path.join(base, "infer_ref", name)
    io_text.write_top_topics(ours, res.weights, res.converged, doc_begin=1)
    conv = int(log_line(irun.log, "Number of docs for which inference "
                        "converged: ").split()[0])
    assert conv == res.num_converged, (conv, res.num_converged)
    if filecmp.cmp(report, ours, shallow=False):
        how = "byte-equal to"
    else:
        how = f"not byte-equal to ({compare_reports(report, ours, k)})"
    for prefix, value in (
            ("Avg LLH per document for converged docs: ",
             res.avg_llh_per_converged_doc),
            ("Avg LLH per word: ", res.avg_llh_per_word)):
        got = float(log_line(irun.log, prefix))
        assert abs(got - value) <= 1e-6 * abs(value), (prefix, got, value)
    cut = int(((ref.model > 0) & (ref.model <= 1e-8)).sum())
    print(f"phase C2: the report {name} {file_lines(report)} is {how} the "
          f"in-process Inferencer's (the written model, infer_corpus(top_n="
          f"5), io_text.write_top_topics); {conv} of {D} docs converged; the "
          f"average LLHs equal the in-process aggregates within 1e-6; the "
          f"model read back from the text file (np.loadtxt in this process "
          f"{load_s:.2f} s) against C1's in memory: max abs diff "
          f"{np.abs(inf.model - ref.model).max():.3e}, {cut} nonzero entries "
          f"at or below the writer's 1e-8 cut")
    del inf, res, parsed
    shutil.rmtree(base)
    print(f"phase C: {time.perf_counter() - t_phase:.1f} s; {card_line()}")


# ---------------------------------------------------------------------------
# Phase P: isle_tpu's PubMed scale test, out of core and in core
# ---------------------------------------------------------------------------

# isle_tpu's scale test (benchmarks/pubmed_scale.py:26, :111-119;
# BASELINE.md's PubMed row): vocab 141,043, 8.2M docs, an nnz target of
# 730M (UCI PubMed's token count, which the reference takes as its nnz
# target), k = 100, document sampling at rate 0.1, edge topics (at most
# 2000), seed 0, chunks of 2^25 entries
PUBMED = dict(vocab=141_043, docs=8_200_000, nnz=730_000_000, k=100,
              edges=2000)
PUBMED_CHUNK_ENTRIES = 1 << 25
PUBMED_SAMPLE_RATE = 0.1
# the scale test's config beyond this script's trainers' (edge topics at
# most PUBMED["edges"]): document sampling, GpuConfig's head budget
PUBMED_CONFIG = dict(sample_docs=True, sample_rate=PUBMED_SAMPLE_RATE,
                     head_bytes=None)
# the unique pairs of bench.synth_corpus at that shape (BENCH_NOTES.md,
# isle_tpu's PubMed runs)
PUBMED_REFERENCE_NNZ = 787_000_000
# synth.synth_corpus_hashed at a cut of the shape, seed 0: the sha256 of
# its offsets, rows and counts; and of the last PUBMED_TAIL_DRAWS raw keys
# (synth.synth_keys_hashed) at the full shape. Made on the CPU;
# tests/test_torch_pubmed.py makes them again there.
PUBMED_PIN_CUT = dict(vocab=141_043, docs=8_200, nnz=730_000)
PUBMED_TAIL_DRAWS = 4096
PUBMED_PINS = {
    "offsets":
        "af144c8bbe45f3f12c862aed62e9906d9fea74fd3fab0c9083cb852b5dda35b6",
    "rows":
        "5e73d2cc874ebe77afadef85fddad85645c6f36270f3c74638d24c05cc6f52a8",
    "counts":
        "fafa9176ab14875dc8a27c1ca1961dbdb907289e8f8c99c4862882771250fa8d",
    "tail_keys":
        "90b5a964f88a007d039a1673c19eadeb2659ef15417c3206c8d315dbedf67fa8",
}


def pubmed_pins(device) -> dict:
    """synth_corpus_hashed's digests in PUBMED_PINS's terms, made on
    `device`."""
    from isle_tpu_torch import synth

    c = PUBMED_PIN_CUT
    arrays = synth.synth_corpus_hashed(c["vocab"], c["docs"], c["nnz"], 0,
                                       device)
    raw = synth.raw_draws(PUBMED["nnz"])
    tail = synth.synth_keys_hashed(PUBMED["vocab"], PUBMED["docs"], 0,
                                   raw - PUBMED_TAIL_DRAWS, raw, device)
    return {**{name: sha256(a.cpu().numpy()) for name, a in
               zip(("offsets", "rows", "counts"), arrays)},
            "tail_keys": sha256(tail.cpu().numpy())}


def mem_available() -> int:
    """The host's MemAvailable in bytes."""
    with open("/proc/meminfo") as f:
        return next(int(line.split()[1]) * 1024 for line in f
                    if line.startswith("MemAvailable:"))


def host_memory() -> str:
    """The host's available memory and this process's present RSS
    (VmRSS) and peak: VmHWM, or where /proc/self/status lacks it (gVisor,
    the card's host), ru_maxrss, which holds this script's own peak as
    long as the shell that started it peaked lower."""
    import resource

    from isle_tpu_torch.cli.train import status_bytes

    rss = status_bytes("VmRSS")
    hwm = status_bytes("VmHWM") or (
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    now = "unknown" if rss is None else f"{rss / 2**30:.2f} GiB"
    return (f"host memory available {mem_available() / 2**30:.1f} GiB, "
            f"this process's RSS {now}, its peak RSS {hwm / 2**30:.2f} GiB")


def pubmed_corpus(shape: dict, seed: int):
    """Phase P0: the pins on the card, then the corpus at `shape` made on
    the card (synth.synth_corpus_hashed) and built on the host
    (synth.corpus_from_csc). Returns the Corpus."""
    from isle_tpu_torch import streaming, synth

    t0 = time.perf_counter()
    got = pubmed_pins("cuda")
    bad = {k: (got[k], PUBMED_PINS[k]) for k in PUBMED_PINS
           if got[k] != PUBMED_PINS[k]}
    assert not bad, f"phase P0: the card's synth_corpus_hashed differs " \
        f"from the CPU's pins in {bad}"
    pins_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    arrays = synth.synth_corpus_hashed(shape["vocab"], shape["docs"],
                                       shape["nnz"], seed, "cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_peak = torch.cuda.max_memory_allocated() - held
    t0 = time.perf_counter()
    offsets, rows, counts = (a.cpu().numpy() for a in arrays)
    del arrays
    torch.cuda.empty_cache()
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    corpus = synth.corpus_from_csc(offsets, rows, counts, shape["vocab"])
    del offsets, rows, counts
    build_s = time.perf_counter() - t0
    chunks = len(list(streaming.doc_chunks(corpus, PUBMED_CHUNK_ENTRIES)))
    lengths = np.diff(corpus.offsets)
    gap = corpus.nnz / PUBMED_REFERENCE_NNZ - 1
    print(f"phase P0, the corpus: the card's synth_corpus_hashed equals "
          f"the CPU's pins (cut {PUBMED_PIN_CUT}, and the last "
          f"{PUBMED_TAIL_DRAWS} draws at the full shape; {pins_s:.2f} s); "
          f"at {shape}: {synth.raw_draws(shape['nnz'])} draws made and "
          f"deduplicated on the card in {gen_s:.2f} s (peak "
          f"{gen_peak / 2**30:.2f} GiB), copied to the host in "
          f"{copy_s:.2f} s, the Corpus built on the host in {build_s:.2f} s; "
          f"nnz {corpus.nnz}"
          + (f" ({gap:+.2%} against the reference's ~{PUBMED_REFERENCE_NNZ})"
             if shape["docs"] == PUBMED["docs"] else "")
          + f", {corpus.nz_docs} non-empty docs, the largest doc "
          f"{int(lengths.max())} entries, avg_doc_sz {corpus.avg_doc_sz:g}, "
          f"{chunks} chunks of at most {PUBMED_CHUNK_ENTRIES} entries; "
          f"{host_memory()}")
    return corpus


@contextlib.contextmanager
def streamed_spies():
    """Spies on a streamed run inside the block: the seconds of
    streaming.counts_dtype (the host check of the counts form), the bytes
    B holds on the card when its build ends and its nnz, the sampling mask
    (streaming.dice_select's, copied), and each attempt of the middle
    (streaming.planned_middle's `run`): its head budget, the bytes held
    at its start and its peak (the peak counters are reset at its start;
    `peak_before` keeps the run's peak until then)."""
    from isle_tpu_torch import streaming

    spy = SimpleNamespace(check_s=0.0, b_bytes=0, nnz_b=0, select=None,
                          middle=[], peak_before=0)
    real = {name: getattr(streaming, name) for name in (
        "counts_dtype", "streamed_build_b", "dice_select", "planned_middle")}

    def counts_dtype(corpus):
        t0 = time.perf_counter()
        try:
            return real["counts_dtype"](corpus)
        finally:
            spy.check_s += time.perf_counter() - t0

    def streamed_build_b(*args, **kw):
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_allocated()
        out = real["streamed_build_b"](*args, **kw)
        torch.cuda.synchronize()
        spy.b_bytes = torch.cuda.memory_allocated() - a0
        spy.nnz_b = out[0].nnz
        return out

    def dice_select(*args, **kw):
        sel = real["dice_select"](*args, **kw)
        spy.select = sel.clone()
        return sel

    def planned_middle(t, loader, nnz_b, run, agree=None):
        def attempt(head, state):
            torch.cuda.synchronize()
            spy.peak_before = max(spy.peak_before,
                                  torch.cuda.max_memory_allocated())
            a0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            try:
                return run(head, state)
            finally:
                torch.cuda.synchronize()
                spy.middle.append((head, a0,
                                   torch.cuda.max_memory_allocated()))

        return real["planned_middle"](t, loader, nnz_b, attempt, agree)

    spies = dict(counts_dtype=counts_dtype, streamed_build_b=streamed_build_b,
                 dice_select=dice_select, planned_middle=planned_middle)
    for name, fn in spies.items():
        setattr(streaming, name, fn)
    try:
        yield spy
    finally:
        for name, fn in real.items():
            setattr(streaming, name, fn)


def pubmed_streamed_run(corpus, shape, seed, out, label,
                        resident_bytes=None) -> tuple:
    """A streamed run of phase P (run_streamed) inside streamed_spies and
    head_rows_built, printed by print_streamed_run. Returns (the trainer,
    its launch counts, its launches by stage, the spy, the head rows)."""
    st = streamed_trainer(corpus, shape, seed, out,
                          resident_bytes=resident_bytes,
                          chunk_entries=PUBMED_CHUNK_ENTRIES,
                          **PUBMED_CONFIG)
    with streamed_spies() as spy, head_rows_built() as rows:
        wall, (peak, held), launches, per = run_streamed(st)
    # the middle reset the peak counters: the run's peak is the larger
    peak = max(peak, spy.peak_before / 2**30)
    print_streamed_run(label, st, wall, (peak, held), launches)
    print(f"{label}: {host_memory()}")
    check_streamed_launches(per, len(st.loader.ranges), label)
    return st, launches, per, spy, rows


def pubmed_streamed(corpus, shape, seed, out) -> tuple:
    """Phase P1: StreamedTrainer on GpuConfig's defaults (the resident
    loader, the memory plan, the hybrid middle, block_ks_device). Returns
    (the trainer, its launch counts, its launches by stage, its spy, the
    head rows it built)."""
    from isle_tpu_torch import streaming

    label = "phase P1, PubMed, streamed, resident (GpuConfig's defaults)"
    st, launches, per, spy, rows = pubmed_streamed_run(
        corpus, shape, seed, os.path.join(out, "pubmed_s"), label)
    loader = st.loader
    assert isinstance(loader, streaming.ResidentLoader), type(loader)
    assert loader.count_dtype == np.uint8, loader.count_dtype
    nnz_b, nb = spy.nnz_b, len(st.original_cols)
    limit = st.gpu.hbm_limit()
    cfg_head = st.gpu.dense_head_bytes
    keep, head = streaming.plan_middle_budget(limit, loader.slab_bytes, nnz_b,
                                              cfg_head)
    assert len(spy.middle) == 1 and spy.middle[0][0] == head, spy.middle
    assert loader.fill_count == (1 if keep else 2), loader.fill_count
    assert len(rows) == 1, rows
    R = rows[0]
    _, a0, mid_peak = spy.middle[0]
    head_real = 2 * R * nb
    per_nnz = (mid_peak - (a0 - spy.b_bytes) - head_real) / nnz_b
    print(f"{label}: counts_dtype's host check {spy.check_s:.2f} s; the "
          f"memory plan (hbm {limit}, slabs {loader.slab_bytes} bytes, "
          f"nnz(B) {nnz_b}, {nb} docs in B, configured head {cfg_head}): "
          f"{plan_outcome(keep, head, cfg_head)}, head budget {head} bytes,"
          f" {R} head rows ({head_real} bytes); B held {spy.b_bytes} bytes "
          f"on the card ({spy.b_bytes / nnz_b:.1f} a nonzero); the middle's "
          f"peak {(mid_peak - a0) / 2**30:.2f} GiB above its start, "
          f"{per_nnz:.1f} bytes a nonzero of B with B and without the head "
          f"(the plan assumes {streaming._MIDDLE_TEMP_B_PER_NNZ} beside a "
          f"head, {streaming._MIDDLE_NOHEAD_B_PER_NNZ} without one)")
    print(f"{label}: result: {check_result(st, shape, label)}; model nnz "
          f"{int(np.count_nonzero(st.model))}; {nb} of {shape['docs']} docs "
          f"sampled into B")
    return st, launches, per, spy, R


def pubmed_b(corpus, st, select, loader):
    """B of a streamed run `st` (its ζ, its sampling mask `select`),
    built again from `loader`."""
    from isle_tpu_torch import streaming

    z = torch.from_numpy(run_dir_arrays(st, "svd")["zetas"]).cuda()
    return streaming.streamed_build_b(corpus, z, select, loader)


def pubmed_wire(corpus, shape, seed, out, p1, spy1) -> tuple:
    """Phase P2: the same run on the wire loader (resident_corpus_bytes
    = 0): ζ, the sampling mask, original_cols and B equal P1's, and the
    run ends where P1's ended, bit for bit. Returns its launch counts."""
    from isle_tpu_torch import streaming

    label = "phase P2, PubMed, streamed, wire"
    st, launches, _, spy, _ = pubmed_streamed_run(
        corpus, shape, seed, os.path.join(out, "pubmed_w"), label,
        resident_bytes=0)
    loader = st.loader
    assert isinstance(loader, streaming.ChunkLoader), type(loader)
    assert torch.equal(spy.select, spy1.select), f"{label}: sampling mask"
    assert_same_run(st, p1, label)
    B, cols = pubmed_b(corpus, st, spy.select, loader)
    B1, cols1 = pubmed_b(corpus, p1, spy1.select, p1.loader)
    assert np.array_equal(cols, cols1) and np.array_equal(cols, st.original_cols)
    assert_same_b(B, B1)
    print(f"{label}: ζ, the sampling mask ({int(spy.select.sum())} docs), "
          f"original_cols, B ({B.nnz} nnz), clusters, catchwords, top-two "
          f"topics, model and edge model equal P1's bit for bit; "
          f"{st.run_bytes_copied} bytes copied against P1's "
          f"{p1.run_bytes_copied} "
          f"({st.run_bytes_copied / p1.run_bytes_copied:.1f} x)")
    del B, st
    return launches, B1, cols1


def pubmed_in_core(corpus, shape, seed, out, p1, B1, cols1) -> tuple:
    """Phase P3: Trainer (in core) on the same corpus and config: ζ,
    original_cols, B, the doc-topic mass, the top-two topics and the edge
    pairs equal P1's, eigenvalues within rtol 1e-4, the model and the
    edge model within 1e-6. Returns (its launch counts, what phase Q
    holds ISLETrain's run against: cli_reference)."""
    from isle_tpu_torch import bmatrix
    from isle_tpu_torch.rng import Draws

    label = "phase P3, PubMed, in core"
    tr, run = timed_train(corpus, shape, seed, os.path.join(out, "pubmed_i"),
                          label, stages=True, **PUBMED_CONFIG)
    print(f"{label}: {host_memory()}")
    upload = dict((s, w) for s, w, _ in tr.timer.phases)["upload A to device"]
    ours, ref = run_dir_arrays(tr, "svd"), run_dir_arrays(p1, "svd")
    for key in ("zetas", "original_cols"):
        assert np.array_equal(ours[key], ref[key]), f"{label}: {key}"
    np.testing.assert_allclose(ours["evalues"], ref["evalues"], rtol=1e-4)
    z = torch.from_numpy(ours["zetas"]).cuda()
    u = Draws(seed).doc_sample_uniforms(shape["docs"])
    IB, in_cols = bmatrix.threshold_and_copy(
        tr.A, z, sample_rate=PUBMED_SAMPLE_RATE, uniforms=u)
    assert np.array_equal(in_cols, cols1), f"{label}: B's docs"
    assert_same_b(IB, B1)
    del IB
    cells, flips, mass_line, mass = pubmed_mass_check(corpus, tr, p1)
    tr.A = None
    torch.cuda.empty_cache()
    print(f"{label}: {mass_line}")
    assert cells == 0 and flips == 0, f"{label}: the doc-topic mass"
    for a, b in zip(tr.top_pairs, p1.top_pairs):
        assert np.array_equal(a, b), f"{label}: top-two topics"
    assert np.array_equal(tr.edge_pairs, p1.edge_pairs), label
    np.testing.assert_allclose(tr.model, p1.model, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.edge_model, p1.edge_model, rtol=0,
                               atol=1e-6)
    same, relabeled = agreement(tr, p1)
    print(f"{label}: upload of A {upload:.3f} s; ζ, original_cols, B, "
          f"the doc-topic mass, the top-two topics and the edge topics "
          f"equal P1's; eigenvalues max rel diff "
          f"{np.abs(ours['evalues'] / ref['evalues'] - 1).max():.2e}; model "
          f"max abs diff {np.abs(tr.model - p1.model).max():.3e} (bit-equal:"
          f" {np.array_equal(tr.model, p1.model)}); clusters equal P1's on "
          f"{same:.4%} of B's docs; result: {check_result(tr, shape, label)}"
          f"; {card_line()}")
    return run.launches, cli_reference(tr, corpus, mass)


def pubmed_mass_check(corpus, tr, p1) -> tuple:
    """The doc-topic mass of the in-core run `tr` (on its A) against the
    streamed pass's over P1's loader, from the same catchwords; the
    model thresholds and contribution weights of both. Returns (the mass
    cells that differ, the weights that differ, a line, the in-core mass
    on the host)."""
    from isle_tpu_torch import streaming, topic_model

    k, D = tr.config.num_topics, tr.corpus.num_docs
    same_cw = all(np.array_equal(a, b)
                  for a, b in zip(tr.catchwords, p1.catchwords))
    cwt = catchword_topics(tr)
    m_in = topic_model.doc_topic_mass(tr.A, cwt, k, tr.gpu.seg_chunk)
    m_st = streaming.streamed_doc_topic_mass(corpus, cwt, k, p1.loader,
                                             tr.gpu.seg_chunk)
    diff = m_in != m_st
    cells = int(diff.sum())
    worst = float((m_in - m_st).abs().max())
    has_cw = topic_model.has_catchwords(cwt, k)
    rank = tr.config.hyper.model_rank_threshold(D, k)
    t_in = topic_model.model_thresholds(m_in, has_cw, rank)
    t_st = topic_model.model_thresholds(m_st, has_cw, rank)
    flips = int(((m_in > t_in) != (m_st > t_st)).sum())
    ties = int((m_in == t_in).sum())
    mass = m_in.cpu().numpy()
    del m_in, m_st, diff
    return cells, flips, (
        f"catchwords equal P1's: {same_cw}; doc-topic mass in core against "
        f"the streamed pass: {cells} cells differ (max abs {worst:.3e}); "
        f"thresholds equal: {bool(torch.equal(t_in, t_st))}; {ties} cells "
        f"tie their topic's threshold in core; contribution weights (mass > "
        f"threshold) differ in {flips} cells"), mass


def pubmed_uses(corpus, p1, per, B1, R: int, seed: int) -> dict:
    """Phase P4: both kernels' uses at the PubMed shapes, each against its
    plain version, the library call and its bound, two launches
    bit-equal: the streamed uses on P1's middle chunk (streamed_uses),
    the r-th group counts on the clustered docs' entries, and B's
    products on P1's hybrid tail (hybrid_uses) beside the head product
    (head_product_uses). Launches: P1's."""
    from isle_tpu_torch import hybrid, streaming

    uses = streamed_uses(p1, corpus, {
        "histogram": per["streamed thresholds"][ONEHOT],
        "mass": per["streamed topic model"][ONEHOT],
        "model": per["streamed topic model"][GATHER],
        "weights": per["streamed doc sampling"][ONEHOT],
    }, "PubMed, ")
    cluster = torch.from_numpy(p1.cluster_of_doc).cuda()
    A_sub = streaming.streamed_filter_clustered(corpus, cluster, p1.loader)
    more = {ONEHOT: [onehot_use(
        "r-th group counts, the clustered docs' entries", A_sub.w_word,
        cluster[A_sub.w_doc], None, corpus.vocab_size, p1.config.num_topics,
        per["streamed catchwords"][ONEHOT])]}
    del A_sub
    z = torch.from_numpy(run_dir_arrays(p1, "svd")["zetas"]).cuda()
    H = streaming.to_hybrid(B1, R, hybrid.row_scale_from_zetas(z))
    assert H.num_head == R
    for name, rows in hybrid_uses(p1, H, B1, seed).items():
        more.setdefault(name, []).extend(rows)
    heads = head_product_uses(H)
    del H
    for name, rows in more.items():
        for u in rows:
            u["use"] = "PubMed, " + u["use"]
        uses.setdefault(name, []).extend(rows)
    print_uses(more, "PubMed streamed path")
    print(f"phase P4, the head product at {R} head rows x {B1.num_docs} "
          "docs (cuBLAS bf16, three pieces; not a ported kernel): " + "; ".join(
              f"{h['direction']} W {h['width']}: {h['ms']:.3f} ms, plain "
              f"{h['plain_ms']:.3f}, bound {h['bound_ms']:.3f} "
              f"({h['bound_by']})" for h in heads))
    return uses


def card_pack_bytes(corpus) -> int:
    """The card bytes mwu.pack_on_device holds at its peak, reckoned from
    its code: the CSR (offsets 8 a doc, rows and values 8 an entry), the
    kept lengths and each row's start and width (16 a doc), and the rows,
    8 bytes a slot of mwu.bucket_layout, here over every entry of a doc:
    an upper bound of the slots its kept entries take."""
    from isle_tpu_torch import mwu

    lengths = np.diff(corpus.offsets)
    _, _, slots = mwu.bucket_layout(lengths, mwu._padded_width(lengths, 8))
    return 8 * (corpus.num_docs + 1) + 8 * corpus.nnz \
        + 16 * corpus.num_docs + 8 * slots


def pack_uses(corpus, mass: np.ndarray, use: str, launches: int,
              host: bool) -> dict:
    """The card pack's two kernels at one shape: each wrapper on the CSR
    of `corpus` on the card, against its plain version on the same card
    tensors (kept lengths equal; word ids and the values' bits equal, in
    mwu.bucket_layout's rows), two launches bit-equal, each timed (CUDA
    events, time_ms) beside its plain version and its bound (the bytes it
    moves once at HBM bandwidth), and with `host` the host's numpy pack
    (mwu.build_infer_batch, both parts, one call) as the library time.
    `launches`: those of the path that ran this shape. Returns {kernel:
    [use]}."""
    from isle_tpu_torch import mwu, pack

    D, V, n = corpus.num_docs, corpus.vocab_size, corpus.nnz
    off, rows, vals = (
        torch.from_numpy(np.ascontiguousarray(x, dtype=t)).cuda()
        for x, t in ((corpus.offsets, np.int64), (corpus.rows, np.int32),
                     (corpus.vals, np.float32)))
    table = torch.from_numpy(pack.keep_table(mass)).cuda()
    kept = pack.pack_kept_lengths(off, rows, table, V)
    kept_eq = torch.equal(kept, pack.pack_kept_lengths(off, rows, table, V))
    assert torch.equal(kept, pack.pack_kept_lengths_plain(
        off, rows, table, V)), f"{use}: kept lengths differ from the plain"
    kept_h = kept.cpu().numpy()
    L = mwu._padded_width(kept_h, 8)
    start, width, slots = mwu.bucket_layout(kept_h, L)
    layout = [torch.from_numpy(x).cuda() for x in (start, width)]
    wi, a = pack.pack_fill(off, rows, vals, table, V, *layout, slots)
    wi2, a2 = pack.pack_fill(off, rows, vals, table, V, *layout, slots)
    fill_eq = torch.equal(wi, wi2) and torch.equal(a.view(torch.int32),
                                                   a2.view(torch.int32))
    del wi2, a2
    pw, pa = pack.pack_fill_plain(off, rows, vals, table, V, *layout, slots)
    assert torch.equal(wi, pw) and torch.equal(
        a.view(torch.int32), pa.view(torch.int32)), \
        f"{use}: the fill differs from the plain version"
    del pw, pa, wi, a
    assert kept_eq and fill_eq, f"{use}: two launches differ"
    torch.cuda.empty_cache()
    library_ms, library = 0.0, "not timed at this shape"
    if host:
        t0 = time.perf_counter()
        mwu.build_infer_batch(corpus, mass)
        library_ms = (time.perf_counter() - t0) * 1e3
        library = "the host's numpy pack, both parts"
    common = dict(launches=launches, max_abs_err=0.0, bit_equal=True,
                  library_ms=library_ms, library=library, bound_by="bytes")
    kept_bytes = 4 * n + 8 * (D + 1) + 4 * D
    fill_bytes = 8 * n + 8 * (D + 1) + 12 * D + 8 * slots
    out = {
        PACK_KEPT: [dict(
            use=use, n=n, shape=[D], **common,
            ms=time_ms(lambda: pack.pack_kept_lengths(off, rows, table, V)),
            plain_ms=time_ms(lambda: pack.pack_kept_lengths_plain(
                off, rows, table, V)),
            bound_ms=kept_bytes / HBM_BYTES_PER_S * 1e3,
            bound_bytes=kept_bytes)],
        PACK_FILL: [dict(
            use=use, n=n, shape=[slots], **common, width=L,
            ms=time_ms(lambda: pack.pack_fill(off, rows, vals, table, V,
                                              *layout, slots)),
            plain_ms=time_ms(lambda: pack.pack_fill_plain(
                off, rows, vals, table, V, *layout, slots)),
            bound_ms=fill_bytes / HBM_BYTES_PER_S * 1e3,
            bound_bytes=fill_bytes)],
    }
    del off, rows, vals, table, layout
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def mwu_blocks():
    """Counts the MWU blocks infer_all runs inside the block."""
    from isle_tpu_torch import mwu

    real, spy = mwu.mwu_core, SimpleNamespace(blocks=0)

    def counted(*args, **kw):
        spy.blocks += 1
        return real(*args, **kw)

    mwu.mwu_core = counted
    try:
        yield spy
    finally:
        mwu.mwu_core = real


def same_bytes(paths: list, whole: str) -> bool:
    """Whether the files `paths`, concatenated, hold the bytes of `whole`."""
    cat, one = hashlib.sha256(), hashlib.sha256()
    for path, h in [(p, cat) for p in paths] + [(whole, one)]:
        with open(path, "rb") as f:
            while chunk := f.read(1 << 24):
                h.update(chunk)
    return (cat.digest() == one.digest()
            and sum(map(os.path.getsize, paths)) == os.path.getsize(whole))


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


def pubmed_infer(corpus, model: np.ndarray, seed: int, out: str):
    """Phase P5: ISLEInfer's path on every doc of P0's corpus with
    ISLETrain's model (phase Q1's M_hat_catch_sparse read back:
    infer_file's normalization, infer_corpus(top_n=5) on the card, the
    report in blocks of inferencer.REPORT_BLOCK_DOCS docs), held against
    the report written as one file, a float64 sample and the first block
    inferred alone, and a range of the benchmark's (a tenth of the docs)
    inferred alone. Both pack kernels are held against their plain
    versions at the range's shape and the whole corpus's (pack_uses), and
    their launches counted from zero just before the whole-corpus run and
    the range's. Returns (what phase Q2 holds ISLEInfer's report against:
    each block's name and sha256, the converged docs and the two average
    LLHs; the pack kernels' uses; their launches by path)."""
    from isle_tpu_torch import inferencer as reports, io_text, mwu, pack

    label = "phase P5, PubMed, ISLEInfer's report blocks"
    D, k = corpus.num_docs, model.shape[1]
    base = os.path.join(out, "pubmed_infer")
    shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()
    need, free = card_pack_bytes(corpus), torch.cuda.mem_get_info()[0]
    print(f"{label}: before the run {host_memory()}; the whole-corpus card "
          f"pack reckoned at {need / 2**30:.1f} GiB, "
          f"{free / 2**30:.1f} GiB free on the card")
    assert need < free, f"{label}: the card cannot hold the whole-corpus " \
        f"pack ({need} bytes reckoned, {free} free)"
    t0 = time.perf_counter()
    unit = corpus.normalized_to_one()
    norm_s = time.perf_counter() - t0
    # the Inferencer's own model mass (its Timer starts when it is made,
    # so it is made after the pack checks)
    mass = model.astype(np.float32).sum(axis=1)
    rng_docs = np.arange(D // 10)
    part = doc_subset(unit, rng_docs)
    uses = pack_uses(part, mass, f"a tenth of PubMed: {len(rng_docs)} "
                     f"docs, {part.nnz} entries", 1, host=True)
    for kernel, rows in pack_uses(
            unit, mass, f"PubMed's whole corpus: {D} docs, "
            f"{unit.nnz} entries", 1, host=False).items():
        uses[kernel] += rows
    inf = inferencer(model, "cuda", base)
    assert np.array_equal(inf.model_mass, mass)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    pack.pack_kept_lengths.launches = pack.pack_fill.launches = 0
    t0 = time.perf_counter()
    with mwu_blocks() as spy:
        res = inf.infer_corpus(unit, top_n=5)
    wall = time.perf_counter() - t0
    launches = {"PubMed, inference, whole corpus": {
        PACK_KEPT: pack.pack_kept_lengths.launches,
        PACK_FILL: pack.pack_fill.launches}}
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    phases = dict((s, w) for s, w, _ in inf.timer.phases)
    t0 = time.perf_counter()
    paths = reports.write_report_blocks(base, inf.config, res, 1)
    blocks_s = time.perf_counter() - t0
    whole = os.path.join(base, "whole")
    t0 = time.perf_counter()
    io_text.write_top_topics(whole, res.weights, res.converged, doc_begin=1)
    whole_s = time.perf_counter() - t0
    B = reports.REPORT_BLOCK_DOCS
    want = [reports.report_name(inf.config, 1 + lo, 1 + min(lo + B, D))
            for lo in range(0, D, B)]
    assert [os.path.basename(p) for p in paths] == want, paths
    assert same_bytes(paths, whole), \
        f"{label}: the blocks' concatenation differs from the whole report"
    blocks = {os.path.basename(p): file_sha256(p) for p in paths}
    ref = SimpleNamespace(blocks=blocks, converged=res.num_converged,
                          avg_doc=res.avg_llh_per_converged_doc,
                          avg_word=res.avg_llh_per_word)
    size, lines = file_lines(whole)
    conv = res.converged
    assert conv.mean() >= 0.9, f"{label}: only {conv.mean():.4f} converged"
    assert np.isfinite(res.llh_per_doc).all() and \
        np.isfinite(res.llh_weighted).all(), f"{label}: LLH not finite"
    err = mwu_sample_check(unit, model, res.weights, conv, seed, top_n=5)

    # the first block alone, with every weight read back
    n1 = min(B, D)
    t0 = time.perf_counter()
    first = inf.infer_corpus(doc_subset(unit, np.arange(n1)))
    first_s = time.perf_counter() - t0
    assert np.array_equal(first.converged, conv[:n1]), \
        f"{label}: the first block alone converges on other docs"
    c1 = first.converged
    sums = first.weights[c1].sum(axis=1, dtype=np.float64)
    assert np.all(np.abs(sums - 1.0) <= 1e-2), f"{label}: rows off 1"
    tv, ti = mwu.top_n_rows(torch.from_numpy(first.weights), 5)
    top = np.zeros_like(first.weights)
    np.put_along_axis(top, ti.numpy(), tv.numpy(), axis=1)
    top = np.where(c1[:, None], top, np.float32(1.0 / k))
    gap = float(np.abs(top - res.weights[:n1]).max())
    same = bool(np.array_equal(top, res.weights[:n1]))
    assert gap <= 1e-6, f"{label}: the first block alone differs by {gap}"
    # the benchmark's range alone
    pack.pack_kept_lengths.launches = pack.pack_fill.launches = 0
    t0 = time.perf_counter()
    ranged = inf.infer_corpus(part, top_n=5)
    range_s = time.perf_counter() - t0
    launches["PubMed, inference, a tenth"] = {
        PACK_KEPT: pack.pack_kept_lengths.launches,
        PACK_FILL: pack.pack_fill.launches}
    assert np.array_equal(ranged.converged, conv[:len(rng_docs)]), \
        f"{label}: the range alone converges on other docs"
    for path, n in launches.items():
        assert n == {PACK_KEPT: 1, PACK_FILL: 1}, (path, n)
    del unit, first, top, res, part, ranged
    shutil.rmtree(base)
    print(f"{label}: {D} docs normalized to unit mass in {norm_s:.2f} s "
          f"(host); infer_corpus(top_n=5) {wall:.2f} s (the card pack "
          f"{phases['pack inference batch']:.2f} s, MWU "
          f"{phases['MWU inference']:.2f} s, {spy.blocks} MWU blocks), peak "
          f"device memory {peak:.2f} GiB above the {held / 2**30:.2f} GiB "
          f"held; {conv.sum()} of {D} docs converged ({conv.mean():.4%}); "
          f"{len(paths)} report blocks in {blocks_s:.2f} s, the one-file "
          f"report in {whole_s:.2f} s ({size} bytes, {lines} lines), the "
          f"blocks' concatenation byte-equal to it; "
          f"{min(MWU_SAMPLE, D)}-doc sample vs float64 CPU max abs err "
          f"{err:.3e}; the first {n1} docs alone ({first_s:.2f} s, every "
          f"weight read back): the same convergence, rows sum to 1 within "
          f"{np.abs(sums - 1.0).max():.2e}, top-5 rows bit-equal to the "
          f"whole run's: {same} (max abs diff {gap:.3e}); the first "
          f"{len(rng_docs)} docs alone {range_s:.2f} s, the same "
          f"convergence; pack kernel launches {launches}; after the phase "
          f"{host_memory()}; {card_line()}")
    print_uses(uses, "PubMed inference")
    return ref, uses, launches


# ---------------------------------------------------------------------------
# Phase Q: ISLETrain and ISLEInfer at PubMed's shape, from a TDF file
# ---------------------------------------------------------------------------

# the most bytes a line of each file phase Q writes takes at PubMed's
# widths (doc ids of 7 digits, words of 6, counts of 2, topics of 4,
# weights below 10 at %.6f or %.10f, a tab or a newline after each
# field): what its disk check reckons with
Q_LINE_BYTES = {"corpus.tdf": 18, "M_hat_catch_sparse": 25,
                "DocCatchword.tsv": 25, "DocTopicCatchwordSums.tsv": 24,
                "EdgeModel_sparse": 25, "TopTwoTopicsPerDoc.txt": 21,
                "report": 24}
Q_SAMPLE_LINES = 4096  # lines a file read back at seeded byte offsets
Q_SPARE = 1.25  # the disk check asks for this much more than it reckons


def cli_reference(tr, corpus, mass: np.ndarray) -> SimpleNamespace:
    """What phase Q holds ISLETrain's run directory against, taken from
    phase P3's trainer `tr` before it is freed: its run directory, its
    config, its model, edge model and edge pairs, top-two topics, each
    word's catchword topic, the doc-topic mass `mass` (from the same
    catchwords, on the host), and the lines each file must have."""
    cwt = catchword_topics(tr, "cpu").numpy()
    t1, t2, valid = tr.top_pairs
    thr = np.float32(1e-8)  # the sparse writer's cut
    lines = {
        "M_hat_catch_sparse": int(np.count_nonzero(tr.model > thr)),
        "TopWordsPerTopic_catch.txt": tr.config.num_topics,
        "DocCatchword.tsv": int(np.count_nonzero(cwt[corpus.rows] >= 0)),
        "DocTopicCatchwordSums.tsv": int(np.count_nonzero(mass)),
        "EdgeModel_sparse": int(np.count_nonzero(tr.edge_model > thr)),
        "EdgeTopicComposition.txt": len(tr.edge_pairs),
        "TopTwoTopicsPerDoc.txt": int(np.count_nonzero(valid)),
    }
    return SimpleNamespace(
        run_dir=tr.run_dir, config=tr.config, gpu=tr.gpu, model=tr.model,
        edge_model=tr.edge_model, edge_pairs=np.asarray(tr.edge_pairs),
        t1=t1, t2=t2, valid=valid, cwt=cwt, mass=mass, lines=lines,
        top_n=max(tr.config.hyper.coherence_num_words, 10))


def q_disk_check(corpus, ref, path: str) -> str:
    """The disk phase Q needs, reckoned from the lines each file will
    hold (Q_LINE_BYTES) and the run directories' checkpoints (the size of
    P3's), against the free bytes of the file system under `path`.
    Raises, naming the bytes, where it falls short."""
    b = Q_LINE_BYTES
    files = {"corpus.tdf": corpus.nnz * b["corpus.tdf"]}
    files.update({name: n * b.get(name, 64) for name, n in ref.lines.items()})
    ckpt = sum(os.path.getsize(os.path.join(ref.run_dir, n))
               for n in os.listdir(ref.run_dir))
    # Q1's checkpoints, P5's blocks and one-file report, Q2's blocks
    reports = 3 * corpus.num_docs * 3 * b["report"]
    need = int(Q_SPARE * (sum(files.values()) + ckpt + reports))
    free = shutil.disk_usage(path).free
    line = (f"disk: phase Q reckons {need} bytes ({Q_SPARE} x the files "
            f"{sum(files.values())}, checkpoints {ckpt}, reports {reports}), "
            f"{free} bytes free under {path}")
    if need > free:
        raise RuntimeError(f"phase Q0: too little disk: {line}")
    return line


def sampled_lines(path: str, n: int, seed: int) -> list:
    """The file's first and last lines and the lines after n seeded byte
    offsets, in file order, each as its tab-separated fields."""
    size = os.path.getsize(path)
    offsets = np.sort(np.random.default_rng(seed).integers(0, size, n))
    with open(path, "rb") as f:
        lines = [f.readline()]
        for o in offsets:
            f.seek(int(o))
            f.readline()  # the rest of the line the offset falls in
            lines.append(f.readline())
        f.seek(max(0, size - 4096))
        lines.append(f.read().splitlines()[-1] + b"\n")
    return [ln.rstrip(b"\n").split(b"\t") for ln in lines if ln]


def sparse_model_readback(path: str, M: np.ndarray, seed: int) -> str:
    """A sparse model file's sampled lines against the array `M` (vocab,
    topics): ids in range, topic-major in (topic, word) order, weights
    above the 1e-8 cut and within the %.10f rounding of M's; its first
    and last lines M's first and last entries above the cut."""
    V, T = M.shape
    rows = sampled_lines(path, Q_SAMPLE_LINES, seed)
    t = np.array([int(r[0]) for r in rows])
    w = np.array([int(r[1]) for r in rows])
    v = np.array([float(r[2]) for r in rows])
    assert t.min() >= 1 and t.max() <= T and w.min() >= 1 and w.max() <= V, \
        f"{path}: ids out of range"
    key = t * (V + 1) + w
    assert np.all(np.diff(key) >= 0), f"{path}: lines out of order"
    want = M[w - 1, t - 1].astype(np.float64)
    assert np.all(want > np.float32(1e-8)), f"{path}: a line under the cut"
    err = float(np.abs(v - want).max())
    assert err <= 5e-11 * (1 + 1e-6), f"{path}: weights off by {err}"
    live = (M > np.float32(1e-8)).any(axis=0)
    t0, t1 = int(np.argmax(live)), T - 1 - int(np.argmax(live[::-1]))
    col0, col1 = M[:, t0] > np.float32(1e-8), M[:, t1] > np.float32(1e-8)
    first = (t0 + 1, int(np.argmax(col0)) + 1)
    last = (t1 + 1, V - int(np.argmax(col1[::-1])))
    assert (t[0], w[0]) == first and (t[-1], w[-1]) == last, \
        (path, (t[0], w[0]), first, (t[-1], w[-1]), last)
    return f"{len(rows)} lines read back, weights within {err:.3e}"


def catchword_entry(corpus, cwt: np.ndarray, last: bool) -> int:
    """The index of the corpus's first (or last) entry whose word is a
    catchword, found a slice of 2^24 entries at a time."""
    step = 1 << 24
    starts = range(0, corpus.nnz, step)
    for a in (reversed(starts) if last else starts):
        hit = np.flatnonzero(cwt[corpus.rows[a:a + step]] >= 0)
        if len(hit):
            return a + int(hit[-1] if last else hit[0])
    raise AssertionError("no entry of a catchword")


def doc_catchword_readback(path: str, corpus, ref, seed: int) -> str:
    """DocCatchword.tsv's sampled lines: ids in range, in the corpus's
    (doc, word) order, each an entry of the corpus whose word is a
    catchword, its value within the %.6f rounding of the corpus's; its
    first and last lines the first and last such entries."""
    rows = sampled_lines(path, Q_SAMPLE_LINES, seed)
    d = np.array([int(r[0]) for r in rows]) - 1
    w = np.array([int(r[1]) for r in rows]) - 1
    v = np.array([float(r[2]) for r in rows])
    D, V = corpus.num_docs, corpus.vocab_size
    assert d.min() >= 0 and d.max() < D and w.min() >= 0 and w.max() < V, \
        f"{path}: ids out of range"
    assert np.all(np.diff(d * V + w) >= 0), f"{path}: lines out of order"
    assert np.all(ref.cwt[w] >= 0), f"{path}: a word that is no catchword"
    lo, hi = corpus.offsets[d], corpus.offsets[d + 1]
    at = np.array([a + np.searchsorted(corpus.rows[a:b], x)
                   for a, b, x in zip(lo, hi, w)])
    assert np.all(at < hi) and np.array_equal(corpus.rows[at], w), \
        f"{path}: a line that is no entry of the corpus"
    err = float(np.abs(v - corpus.vals[at]).max())
    assert err <= 5e-7 * (1 + 1e-6), f"{path}: values off by {err}"
    i0, i1 = (catchword_entry(corpus, ref.cwt, last) for last in (0, 1))
    doc_of = np.searchsorted(corpus.offsets, [i0, i1], side="right") - 1
    assert (d[0], w[0]) == (doc_of[0], corpus.rows[i0]) and \
        (d[-1], w[-1]) == (doc_of[1], corpus.rows[i1]), \
        (path, (d[0], w[0]), (d[-1], w[-1]), doc_of, i0, i1)
    return (f"{len(rows)} lines read back, values within {err:.3e}, the "
            f"largest doc id {int(d.max()) + 1} (2^23 = {1 << 23})")


def doc_topic_sums_readback(path: str, ref, seed: int) -> str:
    """DocTopicCatchwordSums.tsv's sampled lines: ids in range, topics in
    ascending order, each a positive cell of the doc-topic mass within
    the %.6f rounding; its first line topic 0's largest mass (the lowest
    doc of a tie), its last the last topic's smallest (the highest)."""
    mass = ref.mass
    D, k = mass.shape
    rows = sampled_lines(path, Q_SAMPLE_LINES, seed)
    d = np.array([int(r[0]) for r in rows]) - 1
    t = np.array([int(r[1]) for r in rows]) - 1
    v = np.array([float(r[2]) for r in rows])
    assert d.min() >= 0 and d.max() < D and t.min() >= 0 and t.max() < k, \
        f"{path}: ids out of range"
    assert np.all(np.diff(t) >= 0), f"{path}: topics out of order"
    want = mass[d, t].astype(np.float64)
    assert np.all(want != 0), f"{path}: a line for a zero mass"
    err = float(np.abs(v - want).max())
    assert err <= 5e-7 * (1 + 1e-6) + 1e-9 * float(np.abs(want).max()), \
        f"{path}: sums off by {err}"
    live = (mass != 0).any(axis=0)
    ta, tb = int(np.argmax(live)), k - 1 - int(np.argmax(live[::-1]))
    col = mass[:, tb]
    low = col[col != 0].min()
    first = (int(np.argmax(mass[:, ta])), ta)
    last = (int(np.flatnonzero(col == low)[-1]), tb)
    assert (d[0], t[0]) == first and (d[-1], t[-1]) == last, \
        (path, (d[0], t[0]), first, (d[-1], t[-1]), last)
    return f"{len(rows)} lines read back, sums within {err:.3e}"


def top_two_readback(path: str, ref, seed: int) -> str:
    """TopTwoTopicsPerDoc.txt's sampled lines against P3's top-two
    topics, exactly, in doc order, the first and last valid docs."""
    rows = sampled_lines(path, Q_SAMPLE_LINES, seed)
    d, a, b = (np.array([int(r[i]) for r in rows]) - 1 for i in range(3))
    assert np.all(np.diff(d) >= 0), f"{path}: docs out of order"
    assert np.all(ref.valid[d]), f"{path}: a doc without top-two topics"
    assert np.array_equal(a, ref.t1[d]) and np.array_equal(b, ref.t2[d]), \
        f"{path}: top-two topics differ"
    docs = np.flatnonzero(ref.valid)
    assert (d[0], d[-1]) == (docs[0], docs[-1]), (path, d[0], d[-1])
    return f"{len(rows)} lines read back, equal"


def cli_train_readback(run_dir: str, corpus, ref, vocab_words,
                       seed: int) -> list:
    """Every result file of ISLETrain's run directory read back and held
    against P3's arrays (line counts equal the nonzeros they stand for;
    the small files whole, the large ones by sampled lines). Returns a
    line a file."""
    out = []
    for name, want in ref.lines.items():
        size, lines = file_lines(os.path.join(run_dir, name))
        assert lines == want, \
            f"phase Q1: {name} has {lines} lines, {want} expected"
        out.append(f"{name} ({size} bytes, {lines} lines)")
    def path(name):
        return os.path.join(run_dir, name)

    notes = {
        "M_hat_catch_sparse": sparse_model_readback(
            path("M_hat_catch_sparse"), ref.model, seed),
        "EdgeModel_sparse": sparse_model_readback(
            path("EdgeModel_sparse"), ref.edge_model, seed + 1),
        "DocCatchword.tsv": doc_catchword_readback(
            path("DocCatchword.tsv"), corpus, ref, seed + 2),
        "DocTopicCatchwordSums.tsv": doc_topic_sums_readback(
            path("DocTopicCatchwordSums.tsv"), ref, seed + 3),
        "TopTwoTopicsPerDoc.txt": top_two_readback(
            path("TopTwoTopicsPerDoc.txt"), ref, seed + 4),
    }
    pairs = np.loadtxt(path("EdgeTopicComposition.txt"), dtype=np.int64,
                       ndmin=2)
    assert np.array_equal(pairs, ref.edge_pairs.reshape(pairs.shape)), \
        "phase Q1: EdgeTopicComposition.txt differs from P3's edge pairs"
    notes["EdgeTopicComposition.txt"] = "every line equal"
    with open(path("TopWordsPerTopic_catch.txt")) as f:
        got = f.read().splitlines()
    for t, line in enumerate(got):
        top = np.argsort(-ref.model[:, t], kind="stable")[:ref.top_n]
        assert line == "\t".join(vocab_words[w] for w in top), \
            f"phase Q1: topic {t}'s top words differ"
    notes["TopWordsPerTopic_catch.txt"] = "every line equal"
    return [f"{o}: {notes[n]}" for o, n in zip(out, ref.lines)]


def q_files(corpus, ref, out: str) -> SimpleNamespace:
    """Phase Q0: P0's corpus as a 1-based TDF file (the port's triple
    writer) and a vocab file, after the disk check."""
    from isle_tpu_torch import native

    base = os.path.join(out, "pubmed_cli")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    print(f"phase Q0: {q_disk_check(corpus, ref, base)}")
    q = SimpleNamespace(base=base, tdf=os.path.join(base, "corpus.tdf"),
                        vocab=os.path.join(base, "vocab"))
    t0 = time.perf_counter()
    native.write_int_triples(q.tdf, corpus.doc_ids(), corpus.rows,
                             corpus.counts, 1, 1, 0)
    tdf_s = time.perf_counter() - t0
    with open(q.vocab, "w") as f:
        f.write("".join(f"word{w + 1}\n" for w in range(corpus.vocab_size)))
    size = os.path.getsize(q.tdf)
    print(f"phase Q0: the TDF file {size} bytes, {corpus.nnz} lines (Q1 "
          f"reads them back), written by the port's native triple writer "
          f"in {tdf_s:.2f} s ({size / tdf_s / 2**20:.0f} MiB/s); the vocab "
          f"file {file_lines(q.vocab)} (bytes, lines); {host_memory()}")
    return q


def q_train(q, corpus, ref, shape: dict, seed: int) -> tuple:
    """Phase Q1: ISLETrain at PubMed's shape in a process of its own:
    exit code 0 on cuda with the native text I/O, its configuration
    P3's, its checkpoints bit-equal to P3's run directory, every file it
    writes read back against P3's arrays. Returns (its model file, the
    model read back from it)."""
    from isle_tpu_torch import GpuConfig, io_text
    from isle_tpu_torch.cli.train import train_config
    from isle_tpu_torch.corpus import read_vocab_file

    V, D, k = corpus.vocab_size, corpus.num_docs, shape["k"]
    args = [q.tdf, q.vocab, os.path.join(q.base, "train"), str(V), str(D),
            "0", str(k), "0", "1", str(PUBMED_SAMPLE_RATE), "1",
            str(shape["edges"]), "--seed", str(seed)]
    cfg = train_config(args[3:12], seed)
    assert cfg == ref.config and GpuConfig(device="cuda") == ref.gpu, \
        (cfg, ref.config, ref.gpu)
    print(f"phase Q1: python -m isle_tpu_torch.cli.train "
          f"{' '.join(args[3:])}; before it {host_memory()}")
    run = run_cli("isle_tpu_torch.cli.train", args,
                  os.path.join(q.base, "train.log"))
    print(f"phase Q1: {check_cli_run('ISLETrain', run)}")
    print(f"phase Q1: {log_line(run.log, 'ingest: ')}")
    print_cli_stages("ISLETrain", run.log)
    sizes = log_line(run.log, "#docs: ").split()
    assert (sizes[0], sizes[4]) == (str(D), str(corpus.nnz)), \
        f"phase Q1: the CLI read {sizes} from the TDF file"
    run_dir = os.path.join(q.base, "train", cfg.log_dir_name())
    t0 = time.perf_counter()
    for stage in ("svd", "kmeans", "model"):
        name = f"ckpt_{stage}.npz"
        with np.load(os.path.join(run_dir, name)) as a, \
                np.load(os.path.join(ref.run_dir, name)) as b:
            assert sorted(a.files) == sorted(b.files), (name, a.files)
            for key in a.files:
                assert np.array_equal(a[key], b[key]), \
                    f"phase Q1: {name}[{key}] differs from P3's run"
    written = sorted(n for n in os.listdir(run_dir)
                     if not n.endswith(".npz") and n not in CLI_LOGS)
    assert written == sorted(CLI_RESULT_FILES), written
    lines = cli_train_readback(run_dir, corpus, ref,
                               read_vocab_file(q.vocab, V), seed)
    model = io_text.load_sparse_model(
        os.path.join(run_dir, "M_hat_catch_sparse"), k, V)
    gap = float(np.abs(model - ref.model).max())
    print(f"phase Q1: ckpt_svd, ckpt_kmeans and ckpt_model.npz equal P3's "
          f"run bit for bit (ζ, original_cols, eigenvalues, U, centers, "
          f"clusters, the model, catchwords and their thresholds, top-two "
          f"topics); every result file read back against P3's arrays "
          f"({time.perf_counter() - t0:.1f} s): " + "; ".join(lines)
          + f"; the model read back within {gap:.3e} of P3's")
    return os.path.join(run_dir, "M_hat_catch_sparse"), model


def q_infer(q, corpus_shape: tuple, model_file: str, p5,
            k: int) -> None:
    """Phase Q2: ISLEInfer on Q1's model and the whole TDF file in a
    process of its own: exit code 0 on cuda with the native text I/O,
    the report blocks byte-equal to P5's, made in this process from the
    same model read back, the converged count and the average LLHs
    equal P5's."""
    V, D, nnz = corpus_shape
    out = os.path.join(q.base, "infer")
    args = [model_file, q.tdf, out, str(k), str(V), "1", str(D + 1),
            str(nnz), "0", "0", "0"]
    print(f"phase Q2: python -m isle_tpu_torch.cli.infer "
          f"{' '.join(args[3:])}; before it {host_memory()}")
    run = run_cli("isle_tpu_torch.cli.infer", args,
                  os.path.join(q.base, "infer.log"))
    print(f"phase Q2: {check_cli_run('ISLEInfer', run)}")
    print(f"phase Q2: {log_line(run.log, 'ingest: ')}")
    print_cli_stages("ISLEInfer", run.log)
    got = sorted(n for n in os.listdir(out) if n.startswith("top_topics"))
    assert got == sorted(p5.blocks), (got, sorted(p5.blocks))
    for name, digest in p5.blocks.items():
        assert file_sha256(os.path.join(out, name)) == digest, \
            f"phase Q2: {name} differs from P5's block"
    conv = int(log_line(run.log, "Number of docs for which inference "
                        "converged: ").split()[0])
    assert conv == p5.converged, (conv, p5.converged)
    for prefix, value in (
            ("Avg LLH per document for converged docs: ", p5.avg_doc),
            ("Avg LLH per word: ", p5.avg_word)):
        got_v = float(log_line(run.log, prefix))
        assert abs(got_v - value) <= 1e-6 * abs(value), (prefix, got_v, value)
    sizes = sum(os.path.getsize(os.path.join(out, n)) for n in got)
    print(f"phase Q2: {len(got)} report blocks ({sizes} bytes) byte-equal "
          f"to P5's (the same model read back, in this process); {conv} of "
          f"{D} docs converged, as in P5; the average LLHs equal P5's "
          f"within 1e-6")


def free_host_and_card(label: str) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label}: freed; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"held on the card; {host_memory()}")


def pubmed_phase(seed: int, docs: int, out: str) -> tuple:
    """Phase P, isle_tpu's PubMed scale test, and phase Q, both CLIs at
    its shape from a TDF file. Returns ({kernel: its uses at the PubMed
    shapes}, {path: launch counts})."""
    t_phase = time.perf_counter()
    shape = dict(PUBMED)
    if docs != PUBMED["docs"]:
        shape.update(docs=docs, nnz=PUBMED["nnz"] * docs // PUBMED["docs"])
        print(f"CUT: phase P docs {PUBMED['docs']} -> {docs}, nnz target "
              f"{PUBMED['nnz']} -> {shape['nnz']} (vocab and k unchanged)")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase P: {torch.cuda.memory_allocated() / 2**30:.2f} GiB held "
          f"on the card at its start; {card_line()}")
    walls = {}
    t0 = time.perf_counter()
    corpus = pubmed_corpus(shape, seed)
    walls["P0"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p1, launches1, per1, spy1, R = pubmed_streamed(corpus, shape, seed, out)
    walls["P1"] = time.perf_counter() - t0
    launches = {"PubMed, streamed, resident": launches1}
    t0 = time.perf_counter()
    launches["PubMed, streamed, wire"], B1, cols1 = pubmed_wire(
        corpus, shape, seed, out, p1, spy1)
    walls["P2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["PubMed, in core"], ref = pubmed_in_core(
        corpus, shape, seed, out, p1, B1, cols1)
    walls["P3"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    uses = pubmed_uses(corpus, p1, per1, B1, R, seed)
    walls["P4"] = time.perf_counter() - t0
    del p1, B1, spy1
    t0 = time.perf_counter()
    q = q_files(corpus, ref, out)
    walls["Q0"] = time.perf_counter() - t0
    # P1's streamed state and P3's trainer are gone; the corpus stays
    # for Q1's read-back and P5
    free_host_and_card("phase Q1's start")
    t0 = time.perf_counter()
    model_file, model = q_train(q, corpus, ref, shape, seed)
    walls["Q1"] = time.perf_counter() - t0
    del ref
    t0 = time.perf_counter()
    p5, p5_uses, launches_p5 = pubmed_infer(corpus, model, seed, out)
    uses.update(p5_uses)
    launches.update(launches_p5)
    walls["P5"] = time.perf_counter() - t0
    sizes = corpus.vocab_size, corpus.num_docs, corpus.nnz
    del corpus, model
    free_host_and_card("phase Q2's start")
    t0 = time.perf_counter()
    q_infer(q, sizes, model_file, p5, shape["k"])
    walls["Q2"] = time.perf_counter() - t0
    shutil.rmtree(q.base)
    print(f"phase P and Q: {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{k} {w:.1f} s" for k, w in walls.items())
          + f"); {card_line()}")
    return uses, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=NYT["docs"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pubmed-docs", type=int, default=PUBMED["docs"],
                    help="phase P's docs (the nnz target scales with them)")
    args = ap.parse_args()
    T0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    sys.path.insert(0, ROOT)
    from isle_tpu_torch import segsum
    from isle_tpu_torch._build import kernels

    t0 = time.perf_counter()
    lib = kernels()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s) -> {os.path.relpath(lib.path)}")
    spills = 0
    for line in lib.ptxas_log.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            print(f"  ptxas: {line.strip()}")
        if "spill stores" in line:
            spills += int(line.split("bytes spill stores")[0].split(",")[-1])
    assert spills == 0, f"ptxas spilled {spills} bytes"

    out = os.path.join(ROOT, "build", "chip_smoke")
    tiny_entries = synth_entries(TINY, args.seed)
    tiny = make_corpus(tiny_entries, TINY)
    tiny_tr, tiny_cpu = check_tiny(tiny, args.seed, out)

    shape = dict(NYT)
    if args.docs != NYT["docs"]:
        shape.update(docs=args.docs,
                     nnz=NYT["nnz"] * args.docs // NYT["docs"])
        print(f"CUT: docs {NYT['docs']} -> {shape['docs']}, nnz target "
              f"{NYT['nnz']} -> {shape['nnz']} (vocab and k unchanged)")
    t0 = time.perf_counter()
    entries = synth_entries(shape, args.seed)
    corpus = make_corpus(entries, shape)
    print(f"corpus {shape}: nnz {corpus.nnz}, built in "
          f"{time.perf_counter() - t0:.1f} s (host)")

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    segsum.reset_launch_counts()
    t0 = time.perf_counter()
    tr = train(corpus, shape, args.seed, "cuda", os.path.join(out, "nyt"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segsum.launch_counts()
    per_incore = stage_launches(tr)
    coo_run = dict(wall=wall, held=held,
                   peak=torch.cuda.max_memory_allocated() / 2**30)
    print(f"main path: train + edge topics {wall:.2f} s wall, peak device "
          f"memory {coo_run['peak']:.2f} GiB, kernel launches {launches}")
    for label, w, _ in tr.timer.phases:
        print(f"  stage {label}: {w:.3f} s")

    # the repeated runs in turn with runs on the dispatch before the
    # narrow kernel and the tiled passes (B Y untiled)
    walls, before = [wall], []
    for again in ("nyt0", "nyt2", "nyt3", "nyt4", "nyt5"):
        path = os.path.join(out, again)
        if again in ("nyt0", "nyt5"):
            before.append(train_untiled(corpus, shape, args.seed, path, tr))
        else:
            walls.append(train_again(corpus, shape, args.seed, path, tr))
    print(f"COO walls: {', '.join(f'{w:.2f}' for w in walls)} s; on the "
          f"dispatch before the tiled passes (runs 2 and 6 of six) "
          f"{', '.join(f'{w:.2f}' for w in before)} s; {card}")
    cumsum_probe(shape["docs"])

    uses = compare_kernels(tr, launches, args.seed)
    print_uses(uses, "main path")

    need = sum(u["launches"] for u in uses["segsum_onehot"])
    assert launches["segsum_onehot"] >= need, \
        f"segsum_onehot launched {launches['segsum_onehot']} times on the " \
        f"main path, fewer than its {need} uses"
    # every eigensolver operator call (bt_x + b_y), every full-space
    # Lloyd's iteration (bt_x + b_y), the projection and the model SpMM
    need = gather_calls(uses)
    assert launches["segsum_gather_rows"] >= need, \
        f"segsum_gather_rows launched {launches['segsum_gather_rows']} " \
        f"times on the main path, fewer than its {need} SpMM calls"
    print(f"segsum_gather_rows on the main path: "
          f"{launches['segsum_gather_rows']} launches for {need} SpMM calls "
          f"({tr.op_counter.calls} eigensolver operator calls, "
          f"{lloyds_reps(tr)} full-space Lloyd's iterations)")
    print(f"result: {check_result(tr, shape, 'main path')}")

    # E: the eigensolver's two loops on phase 4's B
    device_loop_phase(tr, args.seed, out)

    # H1: the default configuration, the hybrid layout, beside the COO run
    hy, h_launches, h_per, h_uses, h_run = hybrid_phase(
        corpus, shape, args.seed, out, tr, per_incore, tiny)
    # HC: GpuConfig.break_head_cap at 2x and 4x the head cap
    hc_launches = cap_break_phase(corpus, shape, args.seed, out, tr, coo_run,
                                  hy, h_run, h_per)
    cross_layout_phase(corpus, shape, args.seed, out)

    # 7. the other training options and a small inference, card == CPU.
    # Lloyd's meets near ties that rounding decides, so the options run
    # where the card projects the docs exactly as the CPU does: the dense
    # eigensolver (U from the host) and PyTorch's deterministic
    # algorithms (index_add_ without atomics in the projected Lloyd's).
    # Phase 3 runs the default path as it is.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label, opts in OPTIONS.items():
            hyper = dict(opts.get("hyper", {}), eigensolver="dense")
            check_tiny(tiny, args.seed, out, label,
                       **{**opts, "hyper": hyper})
        # S3 on the small corpus: Lanczos, card against CPU
        check_tiny(tiny, args.seed, out, "lanczos",
                   hyper=dict(eigensolver="lanczos"))
    finally:
        torch.use_deterministic_algorithms(False)
    check_tiny_infer(tiny_tr, make_corpus(tiny_entries, TINY,
                                          normalize_to_one=True), out)

    reports_phase(tiny_tr, tiny_cpu)

    # M1-M4: the sharded trainer and doc-parallel inference at world size
    # 1, the C shim, the traced run. The in-core corpus leaves the card
    # first.
    tr.A = None
    torch.cuda.empty_cache()
    import torch.distributed as dist

    mesh, mesh_line = one_rank_mesh(out)
    print(f"sharded phases: {mesh_line}")
    try:
        sh, m_launches, m_per = sharded_phase(corpus, shape, args.seed, out,
                                              tr, mesh, per_incore)
        sharded_calls, sharded_reps = sh.op_counter.calls, lloyds_reps(sh)
        del sh
        torch.cuda.empty_cache()
        # T: the composite training step over the same mesh, the step of
        # graft_entry.entry() and its dry run
        t_use, t_by_use, t_launches = train_step_phase(corpus, shape,
                                                       args.seed, tr, mesh)
        g_launches = graft_entry_phase()
        torch.cuda.empty_cache()
        sharded_infer_phase(tr, entries, shape, out, mesh)
        capi_phase(os.path.join(out, "capi"))
        p_launches, _ = traced_phase(corpus, shape, args.seed, out, tr)
        torch.cuda.empty_cache()
        # each use's launches on the sharded run, beside the main path's:
        # the same kernel or mode as in core, sharded_calls / reps times
        sharded_use_launches = {
            "zeta histogram": 1, "r-th group counts": 1,
            "doc-topic mass": 1, "doc norms of B": 1, "model SpMM B W": 1,
            "eigensolver B^T X": sharded_calls,
            "eigensolver B Y": sharded_calls,
            "Lloyd's B^T C (+ projection)": sharded_reps + 1,
            "Lloyd's B onehot": sharded_reps,
        }
        for rows in uses.values():
            for u in rows:
                n = sharded_use_launches.get(u["use"].replace(", tiled", ""),
                                             0)
                u["launches_sharded"] = n if u["launches"] > 0 else 0
        assert m_launches[ONEHOT] == sum(
            u["launches_sharded"] for u in uses[ONEHOT])
        assert m_launches[GATHER] == gather_calls(uses, "launches_sharded")
        assert m_launches[TILED] == sum(
            u["launches_sharded"] for u in uses[TILED])
        print("launches on the sharded run by use: " + "; ".join(
            f"{u['use']} {u['launches_sharded']}"
            for rows in uses.values() for u in rows))
        uses[ONEHOT].append(t_use)
        for rows in uses.values():
            for u in rows:
                u.setdefault("launches_sharded", 0)
                u["launches_train_step"] = t_by_use.get(u["use"], 0)
        for name in (ONEHOT, GATHER):
            assert t_launches[name] == sum(
                u["launches_train_step"] for u in uses[name]), name

        # S1-S3 and S5: out of core, on one device and over the mesh.
        st, s_launches, s_per, B = streamed_phase(corpus, shape, args.seed,
                                                  out, tr)
        r_launches = streamed_resume_phase(corpus, shape, args.seed, out, tr,
                                           st.loader)
        ss_launches, ss_per, _ = streamed_sampling_phase(corpus, shape,
                                                         args.seed, out, tr)
        ms_launches, ms = sharded_streamed_phase(corpus, shape, args.seed,
                                                 out, st, B, mesh, s_per)
        # H2, H3: the hybrid layout over the mesh and out of core
        mh_launches = hybrid_sharded_phase(corpus, shape, args.seed, out, hy,
                                           h_per, mesh)
        sh_launches, sh = hybrid_streamed_phase(corpus, shape, args.seed, out,
                                                hy)
        # R: the resident corpus and the memory plan, against S1, H3, S5
        res_launches = resident_phase(corpus, shape, args.seed, out, st, B,
                                      ms, sh, mesh)
        del ms, sh
        # Z: the bite corpus, in core, in both layouts, with the drop flags
        # and the options, sharded over the same mesh, out of core, and
        # inferred
        z_uses, z_launches = bite_phase(entries, shape, args.seed, out, mesh)
    finally:
        if mesh.group is not None:
            dist.destroy_process_group()
    s_uses = streamed_uses(st, corpus, {
        "histogram": s_per["streamed thresholds"][ONEHOT],
        "mass": s_per["streamed topic model"][ONEHOT],
        "model": s_per["streamed topic model"][GATHER],
        "weights": ss_per["streamed doc sampling"][ONEHOT],
    })
    l_uses, l_launches = lanczos_phase(B, tr, args.seed, tr.gpu.seg_chunk)
    for more in (s_uses, h_uses, l_uses, z_uses):
        for name, rows in more.items():
            uses[name] += rows
    by_path = {name: {"in-core": launches[name],
                      "sharded, world size 1": m_launches[name],
                      "in-core, traced": p_launches[name],
                      "streamed": s_launches[name],
                      "streamed, resumed": r_launches[name],
                      "streamed, sampled": ss_launches[name],
                      "sharded_streamed": ms_launches[name],
                      "lanczos": l_launches[name],
                      "in-core, hybrid": h_launches[name],
                      "head-past-cap": hc_launches[name],
                      "sharded, hybrid": mh_launches[name],
                      "streamed, hybrid": sh_launches[name],
                      "train-step": t_launches[name],
                      "graft-entry": g_launches[name],
                      **{path: n[name] for path, n in res_launches.items()},
                      **{path: n[name] for path, n in z_launches.items()}}
               for name in uses}
    del st, B

    # 8. inference at full width with the main path's model
    del corpus
    torch.cuda.empty_cache()
    infer_launches = infer_full(tr, entries, shape, args.seed, out)
    for name, n in infer_launches.items():
        uses[name] = []
        by_path[name] = {"inference": n}
    del entries
    # C: both CLIs as a user runs them, on phase 4's corpus
    cli_phase(tr, hy, shape, args.seed, out)
    # M: the micro-benchmarks' kernels, with the NYTimes corpus freed
    m_uses, micro_launches = micro_phase(args.seed)
    uses.update(m_uses)
    for name in uses:
        by_path.setdefault(name, {})["micro"] = micro_launches.get(name, 0)
    # P: isle_tpu's PubMed scale test, with the NYTimes corpus freed
    del tr, tiny_tr, tiny_cpu, hy
    p_uses, p_launches = pubmed_phase(args.seed, args.pubmed_docs, out)
    for name, rows in p_uses.items():
        uses[name] += rows
    for name in uses:
        by_path[name].update({path: n.get(name, 0)
                              for path, n in p_launches.items()})
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "isle_tpu", "bench")]
    assert not bad, f"the port imported {bad}"

    def launched(u):
        return any(u.get(k, 0) > 0 for k in (
            "launches", "launches_sharded", "launches_train_step"))

    # every kernel with a use on a driven path was launched there
    for name, rows in uses.items():
        if any(launched(u) for u in rows):
            assert sum(by_path[name].values()) > 0, (name, by_path[name])
    source = {name: "isle_tpu_torch/csrc/segsum.cu" for name in uses}
    source[PARTIALS] = source[ROWGATHER] = "isle_tpu_torch/csrc/micro.cu"
    source[PACK_KEPT] = source[PACK_FILL] = "isle_tpu_torch/csrc/pack.cu"
    replaces = {PACK_KEPT: "none (isle_tpu/mwu.py packs in host numpy)",
                PACK_FILL: "none (isle_tpu/mwu.py packs in host numpy)",
                ONEHOT: "isle_tpu/pallas_ops.py:236",
                GATHER: "isle_tpu/pallas_ops.py:203",
                NARROW: "isle_tpu/pallas_ops.py:203",
                TILED: "isle_tpu/pallas_ops.py:203",
                PARTIALS: "benchmarks/micro_pallas.py:163",
                ROWGATHER: "benchmarks/micro_pallas_gather.py:69"}

    # the times are summed over the uses that a driven path launched
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source[name],
             replaces=replaces[name],
             launches=sum(by_path[name].values()),
             launches_by_path=by_path[name],
             max_abs_err=max(u["max_abs_err"] for u in rows),
             **{key: sum(u[key] for u in rows if launched(u))
                for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
             bound_by="bytes" if all(u["bound_by"] == "bytes" for u in rows)
             else "operations", uses=rows)
        for name, rows in uses.items()
    ]}))
    print(f"chip_smoke: {time.perf_counter() - T0:.1f} s in all")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
