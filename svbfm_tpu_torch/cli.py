"""libFM-compatible command line of the PyTorch/CUDA port, for the methods
it runs: Gibbs MCMC (``-method mcmc``, the default) and ALS (``-method
als``), batch VBFM (``-method vb``, fast or exact mode), in-memory online
VBFM (``-method vb_online``), and the SGD family: minibatch SGD (``sgd``),
in-memory streaming SGD (``sgd_online``), adaptive-regularisation SGD
(``sgda``, with ``-validation``), the full-batch and the stochastic
exponential-family SGD (``exp_sgd``, ``exp_sgd_stoc``) and pairwise BPR
(``bpr``); regression and binary classification (``-task c``) for every
method, the Poisson task (``-task p``) for sgd, sgd_online, sgda and
exp_sgd_stoc; one device.  ``-relation`` (block structure) runs
natively for mcmc and als, and as the materialised join for every other
method, as ``svbfm_tpu/cli.py`` does.  Train and test files are libFM text
or the reference's binary ``.x``/``.y`` (``.data``/``.target``) beside
the name, which wins where present; with a binary train file and no
``-relation``, vb_online, sgd_online and ``-method vb|mcmc|als
-cache_size N`` stream it from disk and never load it whole
(``-cache_size``: batch VB, Gibbs or ALS with device-windowed rows,
``learners/vb_windowed.py``, ``learners/mcmc_windowed.py``).
``-num_eval_cases n`` evaluates the first n test rows (vb, mcmc and als
also report the rest as ``rmse_test2_*``); the final ``Test=`` is over
them for every method.  ``-checkpoint DIR`` saves the training state every
``-checkpoint_every`` iterations and resumes from the newest checkpoint in
DIR (every method but bpr, and not with ``-cache_size``); ``-rlog FILE``
streams the reference's per-iteration RLog columns; ``-map_eval FIXTURE``
(with ``-map_item_offset``, ``-map_k``) adds MAP@k to the Gibbs/ALS and
vb_online iterations under ``-task c`` and prints the final ``MAP@k``;
``-profile DIR`` writes a ``torch.profiler`` Chrome trace of the training
run to DIR/trace.json.  ``-feature_shards S`` trains batch VB (fast mode,
regression; ``parallel/tp_vb.py``), online VB (in memory, fixed chunk
membership, regression; ``parallel/tp_ovb.py``), Gibbs MCMC and ALS
(regression and ``-task c``; ``parallel/tp_mcmc.py``) or minibatch SGD
(every task; ``parallel/tp_sgd.py``) with the tables
sharded over S ranks of a (data, feature) mesh of every rank, and
``-distributed 1`` joins
the ranks' process group from ``SVBFM_COORDINATOR``,
``SVBFM_NUM_PROCESSES`` and ``SVBFM_PROCESS_ID`` (NCCL on ``cuda``, gloo
on ``cpu``); several ranks of vb, mcmc or als without ``-feature_shards``
train the replicated learner data-parallel on a data mesh of every rank
(``VBLearner``/``MCMCLearner``/``ALSLearner(mesh=)``: each rank a block of
the rows, every table on every rank; ``-factor_block``, ``-task c``,
``-num_eval_cases``, ``-map_eval`` and ``-checkpoint`` read as on one
device); rank 0 prints and writes the files.

    python -m svbfm_tpu_torch.cli -task r -train tr.libfm -test te.libfm \\
        -dim '1,1,20' -method mcmc -iter 10 -device cuda

The flags these methods read keep the names, defaults and meanings of the
JAX package's CLI (``svbfm_tpu/cli.py``); ``-device`` (default ``cuda``)
is the one addition.  The run writes what that CLI writes: ``v_file.txt``
(the initial factors), the reference-named trajectory files
(``test_rmse_<k0><k1><K>_<method>``, ``free_energy_*``) in the working
directory, the ``Final\\tTest=`` line (the RMSE, or under ``-task c``/``p``
the accuracy) and, with ``-out``, the final test predictions (for MCMC the
posterior mean, as the reference's predict(); under ``-task c``/``p``
probabilities: Phi of the scores for vb and vb_online, the posterior mean
of Phi for Gibbs MCMC, the sigmoid for the SGD family).
Every other method and flag exits non-zero with the ROADMAP item that will
bring it; nothing is silently ignored, and ``-device cuda`` without a GPU
is refused rather than run on the CPU.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

HELP = """svbfm-torch — the PyTorch/CUDA port's libFM-compatible CLI
Flags (-name value):
  -task        r=regression, c=binary classification (targets > 0 are
               the positive class), p=Poisson (sgd, sgd_online, sgda,
               exp_sgd_stoc) [MANDATORY]
  -train       filename for training data (libFM text, or binary
               <name>.x/.y or .data/.target) [MANDATORY]
  -test        filename for test data (the same forms) [MANDATORY]
  -meta        filename with one group id per attribute line
  -out         filename for final test predictions
  -dim         'k0,k1,k2': bias,1-way,2-way dim; default=1,1,8
  -iter        number of iterations; default=100
  -method      mcmc|als|vb|vb_online|sgd|sgd_online|sgda|exp_sgd|
               exp_sgd_stoc|bpr; default=mcmc
  -relation    block-structure relation prefixes (comma separated): each
               prefix (libFM text), prefix.groups, prefix.train and
               prefix.test (the joins); native for mcmc/als
  -regular     mcmc/als: 'r0,r1,r2' (or r, or r0 then one r1 and one r2 per
               group) prior precisions; sgd/sgd_online/exp_sgd/exp_sgd_stoc/
               bpr: 'r0,r1,r2' (or r) regularisation; default=0,0,0
  -init_stdev  mcmc/als and the SGD family: stdev of the initial w (mcmc,
               als) and v; default=0.1
  -learn_rate  the SGD family: the step size (1 or 3 values, the first
               one used); default=0.1
  -validation  sgda: filename of the validation data [MANDATORY for sgda]
  -stdev       exp_sgd/exp_sgd_stoc: the residual scale; default=1
  -bpr_neg_field bpr: the field the negatives come from; default=-1 (last)
  -do_sampling mcmc: 0 = no sampling (conditional means); default=1
  -do_multilevel mcmc: 0 = fixed hyperparameters; default=1
  -factor_jacobi als: 1 = factor-Jacobi inside a factor block; default=0
  -batch       number of chunks for vb_online and sgd_online, of batches
               for bpr; default=50
  -reshuffle   vb_online: 1 = re-partition chunk membership every epoch;
               default 0 keeps membership fixed with shuffled order
  -cache_size  vb, mcmc, als: device bytes for the row windows of
               out-of-core batch VB, Gibbs or ALS (0 = all rows resident);
               a binary train file is streamed from disk; default=0
  -num_eval_cases  evaluate the first n test rows (the rest: rmse_test2_*
               for vb, mcmc, als); default=all
  -factor_block  factors per sweep block; 0=all (fast), 1=reference-exact
  -bins        column-bin mode: auto|fields|greedy|jacobi
  -seed        RNG seed
  -rlog        write the per-iteration RLog (tab separated) to this file
  -checkpoint  directory of checkpoints: save the training state and
               resume from the newest one (not bpr; not with -cache_size)
  -checkpoint_every  iterations between checkpoints; default=10
  -map_eval    MAP@k fixture ('<rating> <user>:1 <item>:1' lines aligned
               with the test rows): per-iteration MAP@k (mcmc, als,
               vb_online under -task c) and the final MAP@k
  -map_item_offset  subtracted from the fixture's item ids; default=0
  -map_k       k of MAP@k; default=5
  -profile     directory for a torch.profiler trace (trace.json) of the
               training run
  -feature_shards  vb, vb_online, mcmc, als, sgd: shard the tables over this
               many ranks (vb: fast mode, -task r; vb_online: -task r,
               in memory); must divide the world size; default=1
  -distributed 1 = join the process group of SVBFM_COORDINATOR,
               SVBFM_NUM_PROCESSES, SVBFM_PROCESS_ID (vb, vb_online, mcmc,
               als, sgd; without -feature_shards vb, mcmc and als train
               data-parallel on every rank); default=0
  -verbosity   how much to print; default=0
  -device      torch device to train on; default=cuda (cpu runs the
               kernels' plain PyTorch twins)
  -help        this screen
"""

SUPPORTED = {"task", "train", "test", "meta", "out", "dim", "iter", "method",
             "batch", "reshuffle", "factor_block", "bins", "seed",
             "verbosity", "device", "help", "regular", "init_stdev",
             "do_sampling", "do_multilevel", "factor_jacobi", "learn_rate",
             "validation", "stdev", "bpr_neg_field", "relation",
             "cache_size", "num_eval_cases", "checkpoint",
             "checkpoint_every", "rlog", "map_eval", "map_item_offset",
             "map_k", "profile", "feature_shards", "distributed"}
SGD_METHODS = ("sgd", "sgd_online", "sgda", "exp_sgd", "exp_sgd_stoc", "bpr")
# the methods that read each method-specific flag
FLAG_METHODS = {
    "do_sampling": ("mcmc", "als"),
    "do_multilevel": ("mcmc", "als"),
    "factor_jacobi": ("mcmc", "als"),
    "regular": ("mcmc", "als", "sgd", "sgd_online", "exp_sgd",
                "exp_sgd_stoc", "bpr"),
    "init_stdev": ("mcmc", "als") + SGD_METHODS,
    "learn_rate": SGD_METHODS,
    "validation": ("sgda",),
    "stdev": ("exp_sgd", "exp_sgd_stoc"),
    "bpr_neg_field": ("bpr",),
    "cache_size": ("vb", "mcmc", "als"),
    # bpr's run keeps no checkpoint (svbfm_tpu/learners/bpr.py:225 accepts
    # and ignores one)
    "checkpoint": tuple(m for m in ("mcmc", "als", "vb", "vb_online")
                        + SGD_METHODS if m != "bpr"),
}

_Q1 = "ROADMAP.md queue 1"
# the methods that run feature-sharded or on several ranks
TP_METHODS = ("vb", "vb_online", "mcmc", "als", "sgd")
# the methods whose replicated learner runs data-parallel across ranks
DP_METHODS = ("vb", "mcmc", "als")
METHODS = ("mcmc", "als", "vb", "vb_online") + SGD_METHODS
# the methods that read -task p (svbfm_tpu/learners/sgd.py:87-100)
POISSON_METHODS = ("sgd", "sgd_online", "sgda", "exp_sgd_stoc")


class CmdLine:
    """`-name value` parser with duplicate detection (reference
    ``src/util/cmdline.h:29-197``, as ``svbfm_tpu/cli.py`` parses)."""

    def __init__(self, argv: list[str]):
        self.args: dict[str, str] = {}
        i = 0
        while i < len(argv):
            tok = argv[i]
            if not tok.startswith("-") or _is_number(tok):
                raise SystemExit(f"expected parameter, found '{tok}'")
            name = tok.lstrip("-")
            if name in self.args:
                raise SystemExit(f"the parameter '{name}' is specified twice")
            if i + 1 < len(argv) and (not argv[i + 1].startswith("-")
                                      or _is_number(argv[i + 1])):
                self.args[name] = argv[i + 1]
                i += 2
            else:
                self.args[name] = ""
                i += 1

    def has(self, name: str) -> bool:
        return name in self.args

    def get_str(self, name: str, default: str = "") -> str:
        return self.args.get(name, default)

    def get_int(self, name: str, default: int = 0) -> int:
        v = self.args.get(name, "")
        return int(v) if v else default

    def get_list(self, name: str) -> list[float]:
        v = self.args.get(name, "")
        if not v:
            return []
        return [float(x) for x in v.replace(";", ",").split(",") if x != ""]


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _debug_data(coo) -> None:
    """Data::debug (Data.h:569-579): the first <= 4 rows."""
    first = np.searchsorted(coo.row, np.arange(5), side="left")
    for r in range(min(4, coo.num_rows)):
        ent = " ".join(f"{coo.col[j]}:{coo.val[j]:g}"
                       for j in range(first[r], first[r + 1]))
        print(f"{coo.target[r]:g} {ent}".rstrip())


def _binarised(target: np.ndarray) -> np.ndarray:
    """The classification targets: +1 where the file's is > 0, else -1
    (libfm.cpp:337-350)."""
    return np.where(target > 0, 1.0, -1.0).astype(np.float32)


def main(argv: Optional[list[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = CmdLine(argv)
    if cmd.has("help") or not argv:
        print(HELP)
        return 0
    for name in cmd.args:
        if name not in SUPPORTED:
            raise SystemExit(f"unknown parameter '{name}'")

    task_s = cmd.get_str("task")
    if task_s not in ("r", "c", "p"):
        raise SystemExit("unknown task (use r, c or p)")
    method = cmd.get_str("method", "mcmc").lower()
    if method not in METHODS:
        raise SystemExit(f"unknown method '{method}'")
    if task_s == "p" and method not in POISSON_METHODS:
        raise SystemExit(f"-task p is read by {', '.join(POISSON_METHODS)} "
                         f"alone; for -method {method} it is not ported "
                         f"({_Q1}, item 15)")
    for name, readers in FLAG_METHODS.items():
        if cmd.has(name) and method not in readers:
            raise SystemExit(f"-{name} is not read by -method {method} "
                             f"(only by {', '.join(readers)})")
    if method == "sgda" and not cmd.get_str("validation"):
        raise SystemExit("-validation is mandatory for SGDA")
    lr = cmd.get_list("learn_rate") or [0.1]
    if len(lr) not in (1, 3):
        raise SystemExit("-learn_rate takes 1 or 3 values")
    do_sample = cmd.get_int("do_sampling", 1) != 0
    do_multilevel = cmd.get_int("do_multilevel", 1) != 0
    if method == "als":  # libfm.cpp:131-135
        do_sample = do_multilevel = False
    factor_jacobi = cmd.get_int("factor_jacobi", 0) == 1
    if factor_jacobi and cmd.has("relation"):
        raise SystemExit("-factor_jacobi is not read by the block-structure "
                         "sampler (-relation): its draws are exact")
    if factor_jacobi and do_sample:
        raise SystemExit("-factor_jacobi 1 is not a valid Gibbs kernel: it "
                         "applies only without sampling (-method als or "
                         "-do_sampling 0)")
    cache_bytes = cmd.get_int("cache_size", 0)
    nec = cmd.get_int("num_eval_cases", 0) or None
    if cache_bytes > 0 and factor_jacobi:
        raise SystemExit("-factor_jacobi is not read with -cache_size: the "
                         "windowed Gibbs/ALS draws exactly")
    if cache_bytes > 0 and method in ("mcmc", "als") \
            and cmd.has("relation"):
        raise SystemExit("-cache_size is not read by the block-structure "
                         "sampler (-relation): its rows stay resident")
    if cache_bytes > 0 and nec:  # svbfm_tpu/cli.py:385-390, :408-413
        raise SystemExit("-num_eval_cases is not supported with "
                         "-cache_size")
    if cache_bytes > 0 and cmd.has("checkpoint"):  # svbfm_tpu/cli.py:388
        raise SystemExit("-checkpoint is not supported with -cache_size: "
                         "the windowed learners do not resume")
    if cache_bytes > 0 and cmd.has("bins"):
        raise SystemExit("-bins is not read with -cache_size: the windowed "
                         "plan colours the columns by field structure")
    fs = cmd.get_int("feature_shards", 1)
    distributed = cmd.get_int("distributed", 0) != 0
    for name in ("feature_shards", "distributed"):
        if cmd.has(name) and method not in TP_METHODS:
            # the other methods' data-parallel replicas are still to port
            # (svbfm_tpu/cli.py:349-354 refuses them -feature_shards)
            raise SystemExit(f"-{name} runs -method vb, vb_online, mcmc, als "
                             f"and sgd alone so far; for -method {method} it "
                             f"is not ported ({_Q1}, item 13.4)")
    if fs > 1 and cmd.has("relation"):  # svbfm_tpu/cli.py:356-358
        raise SystemExit("-feature_shards is not supported with -relation "
                         "block structure")

    import os

    import torch

    device = torch.device(cmd.get_str("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("-device cuda: torch.cuda.is_available() is False; "
                         "the port does not fall back to the CPU (pass "
                         "-device cpu to run the plain PyTorch twins)")
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"-device {device}: use cuda or cpu")
    # several ranks: join their process group before anything else
    # (svbfm_tpu/cli.py:160-168)
    from svbfm_tpu_torch.parallel.mesh import distributed_init, process_info
    # without -feature_shards svbfm_tpu/cli.py sends vb, mcmc and als to
    # the replicated learner, data-parallel across the ranks
    # (svbfm_tpu/cli.py:364-424); the others have none in the port yet
    def refuse_dp(why):
        if method not in DP_METHODS and (method not in TP_METHODS or fs == 1):
            how = ("" if method not in TP_METHODS
                   else " without -feature_shards")
            raise SystemExit(f"{why}: -method {method}{how} does not run "
                             "data-parallel across ranks in the port yet "
                             f"({_Q1}, item 13.4)")
    if os.environ.get("SVBFM_COORDINATOR"):
        refuse_dp("SVBFM_COORDINATOR is set")
    if (distributed or os.environ.get("SVBFM_COORDINATOR")) \
            and distributed_init(device=device):
        rank, world = process_info()
        if rank == 0:
            print(f"# distributed: process {rank}/{world}")
    rank, world = process_info()
    tp = fs > 1  # the feature-sharded learners
    dp = world > 1 and not tp  # the replicated ones on a data mesh
    if dp:
        refuse_dp(f"{world} ranks")
        if cmd.has("relation"):
            raise SystemExit("-relation block structure does not run "
                             "data-parallel across ranks in the port yet "
                             f"({_Q1}, item 13.4)")
        if cache_bytes > 0:
            raise SystemExit("-cache_size is not read by the data-parallel "
                             "learners (resident rows)")
    if tp:
        for name, bad in (("cache_size", cache_bytes > 0), ("num_eval_cases",
                          nec), ("map_eval", cmd.has("map_eval"))):
            if bad:
                raise SystemExit(f"-{name} is not read by the feature-"
                                 "sharded learners (resident rows)")
        if method == "vb" and cmd.get_int("factor_block", 0) != 0:
            raise SystemExit("-factor_block is not read by the feature-"
                             "sharded VB (fast mode)")
        if method == "vb" and task_s != "r":
            raise SystemExit("the feature-sharded VB runs -task r alone")
        if method == "vb_online":  # svbfm_tpu/parallel/tp_ovb.py:504-512
            if task_s != "r":
                raise SystemExit("the feature-sharded OVB runs -task r "
                                 "alone")
            if cmd.get_int("factor_block", 0) not in (0, 1):
                raise SystemExit("-factor_block is read by the feature-"
                                 "sharded OVB as 0 or 1 alone (the "
                                 "factor-sequential sweep)")
            for name, bad in (("reshuffle", cmd.get_int("reshuffle") == 1),
                              ("checkpoint", cmd.has("checkpoint"))):
                if bad:
                    raise SystemExit(f"-{name} is not read by the feature-"
                                     "sharded OVB (fixed chunk membership, "
                                     "no checkpoints)")
            from svbfm_tpu_torch.data.binary import has_binary
            if has_binary(cmd.get_str("train")):  # svbfm_tpu/cli.py:429-432
                raise SystemExit("-feature_shards with out-of-core "
                                 "vb_online streaming is not supported; "
                                 "load the train set in memory")
        if fs < 1 or world % fs:
            raise SystemExit(f"-feature_shards {fs} does not divide the "
                             f"world size {world}")

    dim = cmd.get_list("dim") or [1, 1, 8]
    if len(dim) != 3:
        raise SystemExit("-dim needs 3 values 'k0,k1,k2'")
    k0, k1, K = bool(int(dim[0])), bool(int(dim[1])), int(dim[2])
    train_file = cmd.get_str("train")
    test_file = cmd.get_str("test")
    if not train_file or not test_file:
        raise SystemExit("-train and -test are mandatory")
    verbosity = cmd.get_int("verbosity", 0)

    from svbfm_tpu_torch.data.binary import (binary_paths, has_binary,
                                             load_coo_binary)
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.libfm_text import load_libfm_text
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.learners.base import (FMConfig, TASK_CLASSIFICATION,
                                               TASK_POISSON, TASK_REGRESSION,
                                               ref_cdf_gaussian)

    task = {"r": TASK_REGRESSION, "c": TASK_CLASSIFICATION,
            "p": TASK_POISSON}[task_s]

    def _load(path):
        # Data::load takes the binary .x/.y (or .data/.target) where they
        # exist, else the text (Data.h:106-171, svbfm_tpu/cli.py:215-221)
        return (load_coo_binary(path) if has_binary(path)
                else load_libfm_text(path))

    # the online methods never load the train file (libfm.cpp:149-171),
    # nor do the windowed vb, mcmc and als: a binary train file streams
    # from disk (svbfm_tpu/cli.py:222-243)
    defer_train = ((method in ("vb_online", "sgd_online")
                    or (method in ("vb", "mcmc", "als") and cache_bytes > 0))
                   and has_binary(train_file) and not cmd.has("relation"))
    reader = train = None
    if defer_train:
        from svbfm_tpu_torch.data.stream import BinaryChunkReader
        reader = BinaryChunkReader(*binary_paths(train_file))
        if reader.targets is None:
            raise SystemExit(f"{train_file}: no binary targets")
    else:
        train = _load(train_file)
        if verbosity > 0:
            _debug_data(train)
    test = _load(test_file)
    if verbosity > 0:
        _debug_data(test)
    D = max(reader.num_cols if defer_train else train.num_features,
            test.num_features)
    if task == TASK_CLASSIFICATION:  # libfm.cpp:337-350
        for coo in (train, test):
            if coo is not None:
                coo.target = _binarised(coo.target)
        if reader is not None:  # each chunk reads its targets from here
            reader.targets = _binarised(reader.targets)
        min_t, max_t = -1.0, 1.0
    else:
        y = reader.targets if defer_train else train.target
        min_t, max_t = float(y.min()), float(y.max())
    meta = DataMetaInfo(D)
    if cmd.has("meta"):
        meta.load_groups_from_file(cmd.get_str("meta"))

    # relational block structure (libfm.cpp:188-256, svbfm_tpu/cli.py:
    # 273-292): mcmc/als keep the relations factored; every other method
    # trains on the materialised join
    bs_native = None
    if cmd.has("relation"):
        from svbfm_tpu_torch.data.relation import (RelationData,
                                                   build_joined_meta,
                                                   join_relations, load_join)
        prefixes = [r for r in cmd.get_str("relation").replace(
            ";", ",").split(",") if r]
        rels = [RelationData.load(pfx) for pfx in prefixes]
        tr_joins = [load_join(pfx + ".train", train.num_rows)
                    for pfx in prefixes]
        te_joins = [load_join(pfx + ".test", test.num_rows)
                    for pfx in prefixes]
        meta = build_joined_meta(meta, rels)
        if method in ("mcmc", "als"):
            bs_native = (rels, tr_joins, te_joins, D)
        else:
            train = join_relations(train, rels, tr_joins, D)
            test = join_relations(test, rels, te_joins, D)
        D = meta.num_attributes
    G = meta.num_attr_groups
    if verbosity > 0:
        print(f"#attr={meta.num_attributes}\t#groups={G}")
        for g in range(G):
            print(f"#attr_in_group[{g}]={meta.num_attr_per_group[g]}")

    # -regular (libfm.cpp:367-427, svbfm_tpu/cli.py:299-314)
    reg = cmd.get_list("regular")
    reg0 = regw = regv = 0.0
    w_lambda = v_lambda = None
    if len(reg) == 1:
        reg0 = regw = regv = reg[0]
    elif len(reg) == 3:
        reg0, regw, regv = reg
    elif len(reg) == 1 + 2 * G and method in SGD_METHODS:
        raise SystemExit("-regular with one r1 and one r2 per group is read "
                         "by mcmc and als only")
    elif len(reg) == 1 + 2 * G:
        reg0 = reg[0]
        w_lambda = np.asarray(reg[1:1 + G], np.float32)
        v_lambda = np.tile(np.asarray(reg[1 + G:], np.float32)[:, None],
                           (1, K))
    elif reg:
        raise SystemExit("-regular takes 0, 1, 3 or 1+2*num_groups values")

    cfg = FMConfig(
        num_attributes=D, num_factor=K, k0=k0, k1=k1, task=task,
        min_target=min_t, max_target=max_t, num_groups=G,
        num_iter=cmd.get_int("iter", 100), seed=cmd.get_int("seed", 0),
        init_stdev=float(cmd.get_str("init_stdev") or 0.1),
        learn_rate=lr[0], stdev=float(cmd.get_str("stdev") or 1.0), reg0=reg0,
        regw=regw, regv=regv, do_sample=do_sample,
        do_multilevel=do_multilevel,
        factor_block=cmd.get_int("factor_block", 0),
        mcmc_factor_jacobi=factor_jacobi,
        num_batches=cmd.get_int("batch", 50),
        reshuffle=cmd.get_int("reshuffle", 0) == 1)
    bins = cmd.get_str("bins", "auto")
    mesh = None
    if dp:
        from svbfm_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(device=device)
    tr_ds = SparseDataset.from_coo(train, D) if train is not None else None
    te_ds = SparseDataset.from_coo(test, D)
    if method in ("mcmc", "als") and bs_native is not None:
        from svbfm_tpu_torch.learners.mcmc_bs import (ALSBSLearner,
                                                      MCMCBSLearner)
        cls = ALSBSLearner if method == "als" else MCMCBSLearner
        rels, tr_joins, te_joins, d_main = bs_native
        learner = cls(cfg, tr_ds, te_ds, rels, tr_joins, te_joins, meta,
                      d_main, device=device, bins=bins,
                      w_lambda_init=w_lambda, v_lambda_init=v_lambda)
    elif method in ("mcmc", "als") and tp:
        from svbfm_tpu_torch.parallel.mesh import make_mesh2d
        from svbfm_tpu_torch.parallel.tp_mcmc import (TPALSLearner,
                                                      TPMCMCLearner)
        cls = TPALSLearner if method == "als" else TPMCMCLearner
        learner = cls(cfg, tr_ds, te_ds, meta,
                      mesh=make_mesh2d(n_feature=fs, device=device),
                      device=device, bins=bins, write_files=True,
                      w_lambda_init=w_lambda, v_lambda_init=v_lambda)
    elif method in ("mcmc", "als") and cache_bytes > 0:
        from svbfm_tpu_torch.learners.mcmc_windowed import (
            WindowedALSLearner, WindowedMCMCLearner)
        cls = WindowedALSLearner if method == "als" else WindowedMCMCLearner
        learner = cls(cfg, reader if defer_train else tr_ds, te_ds, meta,
                      device=device, cache_bytes=cache_bytes,
                      w_lambda_init=w_lambda, v_lambda_init=v_lambda)
    elif method in ("mcmc", "als"):
        from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
        cls = ALSLearner if method == "als" else MCMCLearner
        learner = cls(cfg, tr_ds, te_ds, meta, device=device, bins=bins,
                      w_lambda_init=w_lambda, v_lambda_init=v_lambda,
                      num_eval_cases=nec, mesh=mesh)
    elif method == "vb" and cache_bytes > 0:
        from svbfm_tpu_torch.learners.vb_windowed import WindowedVBLearner
        learner = WindowedVBLearner(cfg, reader if defer_train else tr_ds,
                                    te_ds, meta, device=device,
                                    cache_bytes=cache_bytes)
    elif method == "vb" and tp:
        from svbfm_tpu_torch.parallel.mesh import make_mesh2d
        from svbfm_tpu_torch.parallel.tp_vb import TPVBLearner
        learner = TPVBLearner(cfg, tr_ds, te_ds, meta,
                              mesh=make_mesh2d(n_feature=fs, device=device),
                              bins=bins, write_files=True)
    elif method == "vb":
        from svbfm_tpu_torch.learners.vb import VBLearner
        learner = VBLearner(cfg, tr_ds, te_ds, meta, device=device, bins=bins,
                            num_eval_cases=nec, mesh=mesh)
    elif method == "vb_online" and tp:
        from svbfm_tpu_torch.parallel.mesh import make_mesh2d
        from svbfm_tpu_torch.parallel.tp_ovb import TPOVBLearner
        learner = TPOVBLearner(cfg, tr_ds, te_ds, meta,
                               mesh=make_mesh2d(n_feature=fs, device=device),
                               bins=bins, write_files=True)
    elif method == "vb_online":
        from svbfm_tpu_torch.learners.vb_online import OVBLearner
        if defer_train:
            learner = OVBLearner.from_reader(cfg, reader, te_ds, meta,
                                             device=device, bins=bins)
        else:
            learner = OVBLearner(cfg, tr_ds, te_ds, meta, device=device,
                                 bins=bins)
    elif method == "sgd" and tp:
        from svbfm_tpu_torch.parallel.mesh import make_mesh2d
        from svbfm_tpu_torch.parallel.tp_sgd import TPSGDLearner
        learner = TPSGDLearner(cfg, tr_ds, te_ds, meta,
                               mesh=make_mesh2d(n_feature=fs, device=device),
                               write_files=True)
    elif method == "sgda":
        from svbfm_tpu_torch.learners.sgd import SGDALearner
        val = load_libfm_text(cmd.get_str("validation"))
        if verbosity > 0:
            _debug_data(val)
        if task == TASK_CLASSIFICATION:
            val.target = _binarised(val.target)
        learner = SGDALearner(cfg, tr_ds, te_ds,
                              SparseDataset.from_coo(val, D), meta,
                              device=device)
    elif method == "bpr":
        from svbfm_tpu_torch.learners.bpr import BPRLearner
        learner = BPRLearner(cfg, tr_ds, te_ds, meta, device=device,
                             neg_field=cmd.get_int("bpr_neg_field", -1))
    else:
        from svbfm_tpu_torch.learners.exp_sgd import (ExpSGDLearner,
                                                      ExpSGDStocLearner)
        from svbfm_tpu_torch.learners.sgd import SGDLearner, SGDOnlineLearner
        cls = {"sgd": SGDLearner, "sgd_online": SGDOnlineLearner,
               "exp_sgd": ExpSGDLearner,
               "exp_sgd_stoc": ExpSGDStocLearner}[method]
        if defer_train:
            learner = SGDOnlineLearner.from_reader(cfg, reader, te_ds, meta,
                                                   device=device)
        else:
            learner = cls(cfg, tr_ds, te_ds, meta, device=device)

    # the initial factors (fm_model::init writes v_file.txt,
    # fm_model.h:92-101); the state is handed to run() below
    init_state = learner.init_state()
    if tp:
        g = learner.global_state(init_state)
        v0 = (g.mu_v if method in ("vb", "vb_online") else g.v)[:, :D]
    else:
        v0 = (init_state.mu_v if method in ("vb", "vb_online")
              else init_state.v)
    lead = rank == 0  # what the ranks print and write, rank 0 does
    if lead:
        np.savetxt("v_file.txt", v0.cpu().numpy(), fmt="%g")
    if verbosity > 0 and lead:
        print(f"num_attributes={D}")
        print(f"use w0={int(k0)}")
        print(f"use w1={int(k1)}")
        print(f"dim v ={K}")
        print(f"reg_w0={reg0:g}")
        print(f"reg_w={regw:g}")
        print(f"reg_v={regv:g}")
        print(f"init ~ N(0,{cfg.init_stdev:g})")
        if method == "sgda":  # adapt_reg.h:346-349
            print("method=sgda")
        if method in SGD_METHODS and method != "bpr":
            print(f"num_iter={cfg.num_iter}")  # fm_learn_sgd.h:66-69
        print(f"task={task}")
        print(f"min_target={min_t:g}")
        print(f"max_target={max_t:g}")
        if method in ("mcmc", "als"):
            print(f"do_multilevel={int(cfg.do_multilevel)}")
            print(f"do_sampling={int(cfg.do_sample)}")
            print(f"num_eval_cases={nec or te_ds.num_rows}")
        print(f"device={device}")

    # the reference's RLog columns, streamed by the learner every
    # iteration (svbfm_tpu/cli.py:345, :496-499)
    from svbfm_tpu_torch.utils.rlog import RLog
    from svbfm_tpu_torch.utils.rlog_schema import register_for
    rlog = RLog((cmd.get_str("rlog") or None) if lead else None)
    register_for(learner, rlog)
    # per-iteration MAP@k inside the Gibbs/ALS and OVB classification
    # loops (svbfm_tpu/cli.py:501-509); the fixture comes from -map_eval
    if cmd.has("map_eval") and task == TASK_CLASSIFICATION \
            and hasattr(type(learner), "map_eval"):
        from svbfm_tpu_torch.learners.base import MapEval
        learner.map_eval = MapEval.from_file(
            cmd.get_str("map_eval"), cmd.get_int("map_item_offset", 0),
            cmd.get_int("map_k", 5))
    run_kw = {}
    if cmd.has("checkpoint"):  # svbfm_tpu/cli.py:535-539
        from svbfm_tpu_torch.utils.checkpoint import CheckpointManager
        run_kw["ckpt"] = CheckpointManager(cmd.get_str("checkpoint"))
        run_kw["ckpt_every"] = cmd.get_int("checkpoint_every", 10)
    from svbfm_tpu_torch.utils.profiling import trace
    with trace((cmd.get_str("profile") or None) if lead else None):
        state, _history = learner.run(state=init_state,
                                      num_iter=cfg.num_iter, verbose=True,
                                      **run_kw)
    rlog.close()

    # final evaluation + -out predictions (libfm.cpp:508-519,
    # svbfm_tpu/cli.py:543-573): sampling MCMC outputs the posterior mean
    # (fm_learn_mcmc.h:355-379), of Phi(score) under classification; the
    # other probit methods Phi of the scores, the SGD family the sigmoid
    if method in ("mcmc", "als"):
        out_vals = learner.final_test_predictions(state)
    elif task == TASK_REGRESSION:
        out_vals = np.clip(learner.predict_test_scores(state), min_t, max_t)
    elif method in ("vb", "vb_online"):
        out_vals = np.clip(ref_cdf_gaussian(torch.from_numpy(
            learner.predict_test_scores(state))).numpy(), 0.0, 1.0)
    else:
        out_vals = 1.0 / (1.0 + np.exp(-np.asarray(
            learner.predict_test_scores(state), np.float64)))
    # the final MAP@k ranks the scores (every rank gathers them)
    map_scores = (learner.predict_test_scores(state)
                  if cmd.has("map_eval") else None)
    # over the first -num_eval_cases rows (svbfm_tpu/cli.py:565-583)
    if not lead:
        return 0
    vals_eval = out_vals[:nec] if nec else out_vals
    target_eval = test.target[:nec] if nec else test.target
    if cmd.has("map_eval"):  # svbfm_tpu/cli.py:568-574, on the scores
        from svbfm_tpu_torch.learners.base import load_map_fixture, map_at_k
        u, i, pos = load_map_fixture(cmd.get_str("map_eval"),
                                     cmd.get_int("map_item_offset", 0))
        mk = cmd.get_int("map_k", 5)
        print(f"MAP@{mk}\t"
              f"{map_at_k(map_scores, u, i, pos, k=mk):.6g}")
    if task == TASK_REGRESSION:
        rmse = float(np.sqrt(np.mean((vals_eval - target_eval) ** 2)))
        print(f"Final\tTest={rmse:.6g}")
    else:
        acc = float(np.mean((vals_eval >= 0.5) == (target_eval > 0)))
        print(f"Final\tTest={acc:.6g}")
    if cmd.has("out"):
        with open(cmd.get_str("out"), "w") as f:
            for v in out_vals:
                f.write(f"{float(v):g}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
