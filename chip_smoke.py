#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-fwd A/flash_fwd.cu B/flash_fwd.cu ...
    python3 chip_smoke.py --compare-bwd A/flash_bwd.cu B/flash_bwd.cu ...

The second and third forms only build the given sources (another
checkout's, with its own headers) and hold and time their fp32 forward
(compare_fwd) or backward (compare_bwd) kernels side by side.  The first
runs these phases, each fatal on failure:
  1. card    — name and power limit (nvidia-smi);
  2. build   — every CUDA source of the port with nvcc for sm_90a, all at
               once, timed, with nvcc's register / shared-memory report; a
               wgmma that ptxas serialises, or a spill in any instance of a
               Hopper kernel (the forward, dQ and dK/dV) or of the fp32
               route's register-blocked kernels (forward, dQ, dK/dV), fails
               it;
  3. kernels — each kernel against its plain PyTorch version on the card at
               the main paths' shapes and the edge cases, with the stated
               tolerances (elementwise and per 64-row tile), and planted
               faults in the kernels' results that the check must refuse;
               the forward bitwise the same over two calls in every fp32
               case, the backward at the bf16 train shape and in every
               fp32 case; kernel, plain
               and library times from CUDA events beside the bound the card
               could reach, at the main shape (the forward at both main
               paths' shapes and the long fp32 one, with its host time per
               call; the backward
               also as a whole, delta and both kernels, beside SDPA's),
               and device times from torch.profiler (from CUDA events,
               said so, where three profiler sessions record no device
               activity); a fault on the card names the case and whether
               the kernel or the plain version met it;
  4. slice   — llama-1b (bf16 weights from a seed) served by the port's
               DecodeSessionCore(engine=False): three requests (prompts of
               2048, 1000 and 17 tokens, each start + 16 next + end), then
               one generate with B = 2.  The kernels' launch counters are set to 0 just before
               and read just after; the 2048-token prefill's logits are
               checked against the same model with reference attention,
               and one start and one next are profiled for device time by
               kernel (torch.profiler);
  5. engine  — llama-1b at full width and depth served by the continuous-
               batching engine (DecodeEngineConfig(max_slots=8,
               prefill_chunk_tokens=32), max_len 2048), its decode step a
               CUDA graph: one graph replay against one eager step from the
               same state (tokens and pos equal, logits within 1e-2
               relative); fp32 streams (prompts of 17, 300 and 1000 tokens,
               32 tokens each) through the engine, through an engine=False
               core and with a shared draft speculating, identical but for a
               printed near-tie; 12 bf16 sessions from client threads over 8
               slots, 4 sharing a 512-token prefix (no error, tokens in
               range, 3 prefix hits, the reckoned prefill chunks, 0 flash
               launches, graph replays = steps); one resume of a stream
               continuing it; step times eager and graph, tokens/s, TTFT
               idle and under load, chunk and speculative times, device busy
               shares, peak memory, the dispatch profile.  The hooks: each
               engine's serve series (prometheus_text) must equal its
               stats() counts and its prefill-chunk and step spans exist;
               a speculating fp32 run with the chaos site serve.spec_verify
               armed to fail falls back to plain steps with the unarmed
               stream;
  6. train   — llama-1b at bench.py's training settings (remat "dots",
               norm_remat, loss_chunk 128, bf16 weights from a seed) through
               make_train_step and torch.optim.AdamW: 8 steps on one batch of
               4 x 1024 tokens with the launch counters set to 0 just before
               and read just after (fwd 32, dq 16, dkv 16 a step); the loss
               must be finite and fall; one step with accum_steps=2; one
               step's loss and gradients against reference attention; step
               time, tokens/s, MFU, peak memory and one profiled step;
  7. moe     — gpt2-small with 8 experts, top 2 (the JAX package's MoE
               training row, tpu_probe21.py:34): 8 train steps on one batch
               of 4 x 1024 tokens (remat off, norm_remat, loss_chunk 128,
               fp32 weights, torch.optim.AdamW; launches fwd, dq, dkv 12 each
               a step), the loss falling, the router aux loss > 0, one step's
               loss and gradients (router, w_in, w_out, wq) against reference
               attention, step time, tokens/s, MFU of the active FLOPs, peak
               memory, a profiled step and one MoE layer's time by part
               (routing, dispatch, experts, combine) with its capacity's
               fill; then served at max_len 1024: fp32 streams (prompts of
               17, 300 and 900 tokens) through the engine and speculating
               (identical but for a printed near-tie), and at capacity factor
               4.0 (no token drops) through the engine and engine=False (12
               flash launches a start); bf16 graph replay bitwise the eager
               step, 8 streams' tokens/s, a 900-token TTFT, 0 flash launches
               on the engine;
  8. vit     — ViT-B/16 at 224 x 224 (tpu_probe20.py:92, :95): 8 train steps
               at batch 64 (launches 12 each a step, the loss falling, one
               step against reference attention, images/s, MFU, peak
               memory), then batch-predict at 256 (images/s, 12 flash
               launches, logits against reference attention);
  9. rl      — a PixelPong conv-PPO rollout (256 envs x 8 steps) and one
               update on the card against the CPU from the same weights,
               draws and permutations (full fp32); then PPO on the card
               at the JAX package's configurations: PixelPong with the conv
               policy at 4096 envs x 64 steps, env_chunk 256, 2 epochs x 4
               minibatches, lr 3e-4 (tpu_probe16.py:40-44) and CartPole
               MLP-PPO at 128 x 128, lr 1e-3 (tpu_probe.py:219-220): a warm
               iteration, 3 timed ones (env-steps/s), one split into the
               rollout and the update, one profiled (device busy share,
               largest kernels, kernels a rollout step), peak memory, a
               finite loss and episode_reward_mean; 0 flash launches;
 10. offpolicy — one Rainbow iteration (double-Q, dueling, 3-step, PER,
               51 atoms; 16 envs x 8 steps, buffer 512) on the card against
               the CPU from the same weights, buffer and draws, full fp32
               (the collect's rows, the first update's sampled slots, C51
               projection, loss and gradients, the priorities, the state
               after 4 updates); then on the card double DQN and Rainbow on
               CartPole at the JAX package's DQN row (128 envs x 32 steps,
               buffer 100,000, batch 256, 16 updates, learn_start 1024;
               tpu_probe2.py:107-111), PG on CartPole at 128 x 128, TD3 and
               SAC on Pendulum and R2D2 on MemoryCue at their configs'
               defaults: warm iterations until the buffer holds learn_start
               rows (asserted), 3 timed (env-steps/s), one split into the
               collect and the updates, one profiled (busy share, largest
               kernels), ops and kernels a collect step and an update, peak
               memory, a finite nonzero loss, episode_reward_mean; 0 flash
               launches;
 11. rl_breadth — full fp32: an IMPALA iteration (CartPole 16 x 8) on
               the card against the CPU from the same weights and draws
               (actions, rewards, dones equal but at a printed near-tie;
               the card's mean rho 1 within 1e-5; V-trace vs and pg_adv,
               loss and clipped gradients within a share of a norm), a
               QMIX iteration past the gate (SpreadLine(4), 8 x 8, buffer
               512: actions, the first update's slots, Q_tot, loss and
               gradients, 4 updates within the measured drift) and 512
               LinTS steps (arms equal but at a printed near-tie, A and
               b); then at the configs' own defaults IMPALA and APPO on
               CartPole 64 x 64, IndependentPPO on SpreadLine(4) 32 x 64
               (and one iteration with shared parameters, whose copies
               must part), QMIX on SpreadLine(4) and MADDPG on
               SpreadLineContinuous(3) past learn_start, an epoch each of
               BC, MARWIL, CQL and CRR over a 20,000-row CartPole dataset
               of a scripted expert collected on the card, one importance-
               sampling estimate, LinUCB and LinTS at 512 steps: warm
               iterations, 3 timed (env-steps, rows or steps a second),
               the collect / update split synced, one profiled (busy
               share, largest kernels), ops and kernels a step, an update,
               an epoch or a minibatch, syncs an iteration, peak memory, a
               finite nonzero loss (bandits: regret falling); 0 flash
               launches.
 12. rl_rest — full fp32: a MAML meta-step (GoalDirection, 4 tasks x 4
               envs; the second-order meta-gradient within a share of a
               norm), an AlphaZero self-play (4 games at 8 simulations;
               visits and actions equal), the Decision Transformer at its
               paper's Gym width (d_model 128, 1 head, 3 layers, K 20,
               batch 64: one step's gradients, an AdamW step and an
               evaluation episode's return) and a SlateQ iteration past
               the gate (rows equal but at a printed near-tie, 4 updates)
               on the card against the CPU; that DT's loss and gradients
               through the fp32 flash kernels against reference attention
               on the card, its launches over one training_step (fwd = dq
               = dkv = 3 a step) and one evaluation episode (1,500
               forwards); then ES and ARS on CartPole, MAML, Dreamer on
               CartPole, DT at its defaults (head dim 16: reference
               attention) and at the paper's width on the rl_breadth
               phase's dataset, AlphaZero on TicTacToe and SlateQ on
               RecSlateEnv at their configs' defaults, measured as in
               rl_breadth (AlphaZero profiled by move); 0 flash launches
               but for DT at the paper's width.
 13. parallel — a one-rank NCCL mesh: Ulysses and the ring at the llama-1b
               train attention shape against reference attention, the
               llama-1b step with FSDP_TP_RULES DTensors bitwise the plain
               step's first loss and grad norm, DD-PPO card = CPU and at its
               defaults.
 14. train_gang — the Train gang on the port's actor layer: llama-1b at the
               train phase's settings through TorchTrainer(num_workers=1)
               with SpmdConfig (a spawned rank, a one-rank NCCL group): its
               first loss and grad norm bitwise the same steps' in this
               process, 32/16/16 launches a step counted in the rank, step
               times both ways, the seconds from fit() to the first report;
               then side by side a restart (tiny fp32 model, a failure at
               step 2, FailureConfig(max_failures=1): resumed from the
               step-1 checkpoint, losses bitwise an uninterrupted run's)
               and a rank SIGKILLed mid-run (fit returns a
               TrainingFailedError naming rank 0 and exit code -9 within
               30 s); then (d) llama-1b as in (a) in a one-rank gang with
               FailureConfig(max_failures=1): params and the AdamW state
               saved once with Checkpoint.from_pytree after step 1 and
               reported, a failure at step 2, the restarted rank restoring
               the save with to_pytree onto its card: steps 2-3 bitwise
               (a)'s, 32/16/16 launches a step, the save's bytes and
               seconds, the manager's register (copy) seconds, the
               restore's seconds and the disk before the save; no child
               process left.
 15. host_dp — ViT-B/16 at batch 64 trained host data-parallel: each
               step's gradients through host_collective.allreduce_pytree,
               first in this process with no gang, then through
               TorchTrainer(num_workers=1, backend_config=HostArrayConfig())
               (the trainer's TCPStore, no process group): the losses of 3
               steps bitwise the in-process loop's, 12/12/12 launches a
               step, the step split into card work and the host reduce, the
               reduce's bytes and GB/s, the most the store held.
 16. serve_gang — llama-1b at full width (bf16 weights from seed 0, flash
               attention) served in this process on plain weights, then by
               a one-member NCCL gang replica (serve.gang.start_gang_replica,
               tests/torch_serve_gang_models.py's ShardedModel) whose member
               places the same weights under FSDP_TP_RULES: forward of a
               1 x 2048 prompt and generate (B 2, a 1000-token prompt, 32
               new tokens), a warm request and 5 timed of each; every
               forward summary (shape, mean, bit-pattern checksum, last
               argmax) and every token bitwise the in-process ones, 16
               flash_fwd launches and no backward launch a request counted
               in the member; seconds from start_gang_replica to ready, the
               medians through the gang, in the member and in process,
               peak member memory; the leader SIGKILLed 0.05 s into a
               generate (ActorDiedError, then ReplicaUnavailableError) and
               no process left.
The kernel phases also hold and time each kernel at the MoE train shape,
the ViT shapes and the DT shapes (fp32, 60 tokens, one head of 128; the
planted faults there include the causal mask left off and the first key
dropped, since no key tile lies inside one tile), and both also at the
long fp32 shape (b 1, s 1024, 32/8 heads, d 64).  Each phase prints its
seconds.  Then one JSON line of the engine's numbers, one of the moe and
vit phases' (with the phase seconds), one of the rl phase's, one of the
offpolicy phase's, one of the rl_breadth phase's, one of the rl_rest
phase's, one of the parallel phase's, one of the train_gang phase's, one
of the host_dp phase's, one of the serve_gang phase's, one of the kernels,
and last the device line.
Exits non-zero without a result when no CUDA device is present.
"""

import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM dense
PEAK_BYTES = 3.35e12                                          # H100 SXM HBM3
# O: |kernel - plain| <= atol + rtol * |plain|, atol = rtol; LSE: atol.
# bf16 rounds P and O at other block boundaries than the plain version;
# fp32 differs only in summation order.
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}
# The elementwise bounds are as large as many values of O and of the
# gradients, so they guard single elements only.  What fails a wrong kernel
# is TILE_TOL, on the relative error of every 64-row tile of each batch and
# head (ops.tile_rel_err), whatever its scale: a tile, a query head of a
# group, a KV head or a key range left out scores 0.1 to 1.5, bf16's
# roundings alone about 2.4e-3 (O) and 3e-3 (gradients), the plain version
# in bf16 against fp32 on the CPU.  Planted faults of those kinds must fail
# it in every bf16 case.
TILE_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# (name, b, s_q, s_kv, h, h_kv, d, dtype, causal); the first is the serve
# path's shape (llama-1b, one 2048-token prompt), the second the train
# step's (4 x 1024 tokens)
CASES = [
    ("main", 1, 2048, 2048, 32, 8, 64, torch.bfloat16, True),
    ("train", 4, 1024, 1024, 32, 8, 64, torch.bfloat16, True),
    ("s_q<s_kv", 1, 512, 2048, 32, 8, 64, torch.bfloat16, True),
    ("s_q>s_kv", 1, 2048, 1000, 32, 8, 64, torch.bfloat16, True),
    ("ragged", 1, 1000, 1000, 32, 8, 64, torch.bfloat16, True),
    ("non-causal", 2, 1000, 1000, 32, 8, 64, torch.bfloat16, False),
    ("d128", 1, 2048, 2048, 24, 8, 128, torch.bfloat16, True),
    ("fp32", 1, 1024, 1024, 32, 8, 64, torch.float32, True),
    # gpt2-small's MoE train step (MHA, 12 heads) and ViT-B/16's train and
    # batch-predict shapes (197 rows: two 128-row tiles, the second 54%
    # full; bidirectional)
    ("moe-train", 4, 1024, 1024, 12, 12, 64, torch.bfloat16, True),
    ("vit", 64, 197, 197, 12, 12, 64, torch.bfloat16, False),
    ("vit-predict", 256, 197, 197, 12, 12, 64, torch.bfloat16, False),
    # the Decision Transformer at the Gym width of its paper (rl_rest):
    # fp32, one head of 128, 3 x 20 tokens, shorter than one tile; a
    # minibatch of 64 in training, one context in the evaluation rollout
    ("dt", 64, 60, 60, 1, 1, 128, torch.float32, True),
    ("dt-eval", 1, 60, 60, 1, 1, 128, torch.float32, True),
]
PROMPTS = (2048, 1000, 17)
NEXT_STEPS = 16
# dQ, dK, dV, elementwise, atol = rtol = BWD_TOL: bf16's S and dP come out
# of the tensor cores in another summation order than the plain fp32
# products, so a few P and dS values round to bf16 the other way, and the
# outputs are rounded to bf16; fp32 differs in summation order only.  Each
# is also held to TILE_TOL.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# (name, b, s_q, s_kv, h, h_kv, d, dtype, causal); the first is the train
# step's shape: llama-1b, 4 x 1024 tokens
BWD_CASES = [
    ("main", 4, 1024, 1024, 32, 8, 64, torch.bfloat16, True),
    ("s_q<s_kv", 1, 512, 2048, 32, 8, 64, torch.bfloat16, True),
    ("s_q>s_kv", 1, 2048, 1000, 32, 8, 64, torch.bfloat16, True),
    ("ragged", 1, 1000, 1000, 32, 8, 64, torch.bfloat16, True),
    ("non-causal", 2, 1000, 1000, 32, 8, 64, torch.bfloat16, False),
    ("d128", 1, 2048, 2048, 24, 8, 128, torch.bfloat16, True),
    ("fp32", 1, 1024, 1024, 32, 8, 64, torch.float32, True),
    ("MHA", 2, 1024, 1024, 16, 16, 64, torch.bfloat16, True),
    ("moe-train", 4, 1024, 1024, 12, 12, 64, torch.bfloat16, True),
    ("vit", 64, 197, 197, 12, 12, 64, torch.bfloat16, False),
    ("dt", 64, 60, 60, 1, 1, 128, torch.float32, True),
]
# the shapes each kernel is timed at: {label: case name}
TIMED_FWD = {"serve": "main", "train": "train", "moe_train": "moe-train",
             "vit": "vit", "vit_predict": "vit-predict", "dt": "dt",
             "dt_eval": "dt-eval", "fp32": "fp32"}
TIMED_BWD = {"train": "main", "moe_train": "moe-train", "vit": "vit",
             "dt": "dt", "fp32": "fp32"}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 8
# the engine phase: llama-1b, DecodeEngineConfig(max_slots=8,
# prefill_chunk_tokens=32), max_len 2048
ENGINE_MAX_LEN, ENGINE_SLOTS, ENGINE_CHUNK = 2048, 8, 32
STREAM_PROMPTS, STREAM_TOKENS = (17, 300, 1000), 32   # fp32 stream checks
# the load run: 4 prompts of a shared 512-token prefix and a suffix of
# these lengths, 8 other prompts, 64 tokens drained from each
SHARED_PREFIX, SHARED_SUFFIXES = 512, (40, 100, 9, 300)
LOAD_PROMPTS, LOAD_TOKENS = (17, 1000, 250, 64, 777, 33, 500, 128), 64
# two streams may part only where the reference's top two logits are
# within this share of the top one: fp32 products summed in another order
# differ by about 1e-6; bf16 logits carry 8 significant bits (2^-8 = 3.9e-3
# a step), and a replay computes the same K/V rows in other products
TIE_FP32, TIE_BF16 = 1e-4, 1e-2
# 8 streams of 17-token prompts decode for this long: at the step's bound
# (about 1.05 ms) they stay well inside max_len
THROUGHPUT_WINDOW_S = 1.0
# the moe phase: gpt2-small with 8 experts, top 2, the JAX package's MoE
# training row (tpu_probe21.py:34, small_moe_e8k2_b4, run by
# probe_common.py:93-123); served at its max_seq_len with the engine
# phase's DecodeEngineConfig
MOE_CONFIG = dict(n_experts=8, expert_top_k=2)
MOE_MAX_LEN = 1024
MOE_STREAM_PROMPTS, MOE_TTFT_PROMPT = (17, 300, 900), 900
# the vit phase: ViT-B/16, train at batch 64 and batch-predict at 256
# (tpu_probe20.py:92, :95)
VIT_TRAIN_BATCH, VIT_PREDICT_BATCH = 64, 256
# the rl phase: PPO with the conv policy on PixelPong at the JAX package's
# configuration (tpu_probe16.py:40-44, stage rl_ppo_pixel), and CartPole
# MLP-PPO at 128 x 128, lr 1e-3 (tpu_probe.py:219-220); the card = CPU
# check runs a short PixelPong rollout and one update in fp32
RL_PONG = dict(num_envs=4096, rollout_length=64, env_chunk=256,
               num_sgd_epochs=2, num_minibatches=4, lr=3e-4, seed=0)
RL_CARTPOLE = dict(num_envs=128, rollout_length=128, lr=1e-3, seed=0)
RL_TIMED_ITERS = 3
RL_PARITY_ENVS, RL_PARITY_STEPS = 256, 8
# card against CPU, full fp32: observations, actions, rewards and dones
# exactly; log-probs and values (conv and products summed in another order)
# within rtol 1e-4 / atol 1e-5.  One update of the same batch (8 Adam
# steps): the first minibatch's gradients, from the same params, within
# 1e-4 of each leaf's norm (the CPU tests' update bound against the JAX
# package; 1.7e-6 measured on an H100).  After that the two sides
# step from params that differ by rounding, and Adam divides each gradient
# element by its own running scale, so an element whose gradient is near
# zero turns rounding into a share of a step, which the later gradients
# carry on: an H100 run measured params up to 0.121 of a step (lr), Adam
# moments 2.7e-3 of a leaf's norm, the last minibatch's loss parts 9.4e-6
# apart.  The bounds below are about four times those.
RL_TOL = (1e-4, 1e-5)
RL_GRAD_TOL, RL_MOMENT_TOL, RL_PARAM_STEPS, RL_LOSS_TOL = \
    1e-4, 2e-2, 0.5, (2e-3, 1e-6)
# a sampled action may differ only where pi + noise had its top two this
# close (fp32 logits of about 0.1 carry errors of about 1e-8)
RL_TIE = 1e-5
# the parallel phase: attention at the llama-1b train shape (b, s, heads,
# kv heads, head dim), train steps a side, and DD-PPO's card = CPU
# iteration (CartPole, 16 envs x 16 steps at DDPPOConfig's 4 epochs x 4
# minibatches: 16 Adam steps, bounded as the rl phase's update)
PAR_ATTENTION = (TRAIN_BATCH, TRAIN_SEQ, 32, 8, 64)
PAR_TRAIN_STEPS = 5
PAR_DDPPO_PARITY = dict(num_envs=16, rollout_length=16, seed=0)
# the train_gang phase: llama-1b steps through TorchTrainer (the train
# phase's settings), the tiny fp32 model of tests/test_train.py:47-76 for
# the restart (a failure at step 2 of 4) and the killed rank, the bound on
# noticing that kill, and where the gang's checkpoints go (removed after)
GANG_STEPS = 4
GANG_LLAMA = dict(max_seq_len=TRAIN_SEQ, remat="dots", norm_remat=True,
                  loss_chunk=128, param_dtype=torch.bfloat16)
GANG_TINY = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                 max_seq_len=32, dtype=torch.float32)
GANG_TINY_STEPS, GANG_FAIL_AT = 4, 2
GANG_KILL_BOUND_S = 30.0
# train_gang (d): the rank saves params and AdamW state with from_pytree
# after step GANG_RESUME_AT - 1, fails once at GANG_RESUME_AT and the
# restarted rank restores the save and runs the rest of GANG_STEPS; the
# disk must hold the save twice (the rank's and the manager's copy)
GANG_RESUME_AT = 2
GANG_DISK_FACTOR = 2.2
# the host_dp phase: ViT-B/16 at the vit phase's batch, trained host
# data-parallel (each step's gradients through host_collective)
HOST_DP_STEPS = 3
GANG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "train_gang")
# the serve_gang phase: llama-1b (bf16, flash) in a one-member gang replica
# through forward (a 1 x 2048 prompt) and generate (B 2, a 1000-token
# prompt, 32 new tokens), each request SERVE_GANG_REQUESTS times after one
# warm request, through the gang and in this process
SERVE_GANG_FORWARD = (1, 2048)
SERVE_GANG_GENERATE = (2, 1000, 32)
SERVE_GANG_REQUESTS = 5
SERVE_GANG_KILL_BOUND_S = 30.0
# the offpolicy phase: double DQN on CartPole at the JAX package's DQN row
# (tpu_probe2.py:107-111, stage rl_dqn_tpu) and Rainbow at its sizes; PG on
# CartPole at the PPO CartPole row's 128 x 128 (tpu_probe.py:219-220) with
# PGConfig's own lr; TD3, SAC (td3.py:42-67, sac.py:38-55) and R2D2
# (r2d2.py:96-114) at their configs' defaults.  The card = CPU check runs
# one small Rainbow iteration in fp32.
OFF_DQN = dict(num_envs=128, rollout_steps=32, buffer_capacity=100_000,
               batch_size=256, num_updates=16, learn_start=1024, seed=0)
OFF_PG = dict(num_envs=128, rollout_length=128, seed=0)
OFF_TIMED_ITERS = 3
OFF_PARITY = dict(num_envs=16, rollout_steps=8, buffer_capacity=512,
                  batch_size=32, num_updates=4, learn_start=64, seed=0,
                  eps_start=0.3)          # most actions greedy
# card against CPU, full fp32.  The collect: actions, rewards, dones,
# cursor and size exactly; observations within rtol 1e-5 / atol 1e-6, the
# CPU tests' env-step bound (CartPole's sin and cos round differently in
# the two libraries: 2.4e-7 apart after 8 steps in the first H100 run, a
# large relative error where a velocity is near 0); an action may differ
# only where the CPU's Q top two were within OFF_TIE.  The first update from
# the same buffer and indices: projection, loss, gradients within 1e-5 of
# a norm, the priorities it writes 1e-5 relative.  Later updates' samples
# may part only where the uniform fell within OFF_SAMPLE_TIE of a slot's
# edge in the cumulative priorities (float64 on both sides).
OFF_PARITY_TOL = (1e-5, 1e-6)
OFF_TIE = 1e-5
OFF_FIRST_TOL = 1e-5
OFF_SAMPLE_TIE = 1e-9
# After the 4 updates, each side's Adam steps from params that differ by
# rounding (the C51 projection's scatter-add sums in another order on the
# card): the first H100 run measured the losses 1.33e-7 apart (relative),
# the priorities 1.65e-6, the params 0.0011 of an Adam step (lr), the
# moments 3.9e-6 of a norm, and the first update 3.1e-6 (projection) and
# 2.6e-6 (gradients) of a norm.  The bounds are about ten times those.
OFF_LATER_TOL = {"loss": 2e-6, "priorities": 2e-5, "params_in_steps": 0.01,
                 "moments": 5e-5}
# the rl_breadth phase, each run at its config's own defaults (nothing
# cut): IMPALA and APPO on CartPole at 64 envs x 64 steps, (64, 64)
# (impala.py:41-58), IndependentPPO on SpreadLine(4) at 32 x 64, 2 epochs
# (multi_agent.py:107-120), QMIX on SpreadLine(4) at 16 x 32, buffer
# 50,000, batch 128, 16 updates, learn_start 1,000 (qmix.py:64-83),
# MADDPG on SpreadLineContinuous(3) at 16 x 16, buffer 100,000, batch 256,
# 16 updates (maddpg.py:85-101), a 20,000-row CartPole dataset of
# tests/test_offline_rl.py's scripted expert at 32 envs with an epoch of
# BC, MARWIL, CQL and CRR at batch 256 (offline.py), LinUCB and LinTS at
# 512 steps an iteration on LinearContextBandit(d 8, K 4) (bandit.py).
BREADTH_TIMED_ITERS = 3
BREADTH_AGENTS = 4
BREADTH_DATASET_ROWS, BREADTH_DATASET_ENVS = 20_000, 32
BREADTH_IMPALA_PARITY = dict(num_envs=16, rollout_length=8, seed=0)
BREADTH_QMIX_PARITY = dict(num_envs=8, rollout_steps=8,
                           buffer_capacity=512, batch_size=32,
                           num_updates=4, learn_start=64, eps_start=0.3,
                           seed=0)
# card against CPU, full fp32.  The first H100 run measured: IMPALA's
# observations 1.8e-7 apart (max |diff|), log-probs 6.0e-8, the card's mean
# rho exactly 1, and from one batch vs 8.3e-8, pg_adv 1.2e-7, the loss 0,
# the gradients (clipped or not) 4.0e-7 of a norm; QMIX's rewards 4.8e-7
# apart, the first update's Q_tot 1.7e-7, loss 1.0e-7, gradients 4.9e-7 of
# a norm, after 4 updates the loss 1.1e-7 relative and the params 6.0e-5 of
# an Adam step (lr); LinTS's arms equal over 512 steps, A and b 7.2e-8 of
# their largest entry.  The bounds are about ten times those (rho: 1e-5,
# the bound the phase was specified with).  A LinTS arm may part only
# where the CPU's Thompson payoffs had their top two within BREADTH_TIE of
# the largest.
BREADTH_RHO = 1e-5        # |mean rho - 1| in inline mode
BREADTH_TOL = {"impala": 5e-6, "qmix_first": 5e-6, "qmix_loss": 2e-6,
               "qmix_params_in_steps": 1e-3, "lints": 1e-6}
BREADTH_TIE = {"lints": 1e-5}
# the rl_rest phase, each run at its config's own defaults (es.py, maml.py,
# dreamer.py, dt.py, alpha_zero.py, slateq.py), and the Decision
# Transformer also at the Gym width of Chen et al. 2021 ("Decision
# Transformer", appendix, Gym hyperparameters: 3 layers, 1 head, embedding
# 128, context 20, batch 64, lr 1e-4, weight decay 1e-4; d_ff 4 x 128) on
# the rl_breadth phase's 20,000-row CartPole expert dataset.  The card =
# CPU checks run a MAML meta-step at 4 tasks x 4 envs, an AlphaZero
# self-play of 4 games at 8 simulations, a DT step and episode at the
# paper's width, and a SlateQ iteration past the gate at 16 envs x 8 steps.
DT_PAPER = dict(d_model=128, n_heads=1, n_layers=3, context_len=20,
                batch_size=64, d_ff=512, lr=1e-4, seed=0)
REST_MAML_PARITY = dict(meta_batch_size=4, num_envs=4, seed=0)
REST_AZ_PARITY = dict(games_per_iter=4, num_simulations=8, batch_size=36,
                      seed=0)
REST_SLATE_PARITY = dict(num_envs=16, rollout_steps=8, buffer_capacity=512,
                         batch_size=32, num_updates=4, learn_start=64,
                         eps_start=0.3, seed=0)
# card against CPU (and flash against reference attention on the card),
# full fp32.  The first H100 run measured: MAML's meta-loss 4.9e-6 apart
# (relative), its reward means 1.9e-9, the meta-gradient 1.4e-6 of a norm;
# AlphaZero's visits and boards equal; DT's loss 7.8e-8 and gradients
# 6.3e-7 of a norm (flash on the card, reference on the CPU), the episode's
# return equal; flash against reference attention on the card: loss equal,
# gradients 1.0e-6 of a norm; SlateQ's 128 rows equal, the loss after 4
# updates 2.1e-7 apart and the params 6.0e-5 of an Adam step.  The bounds
# are about ten times those; SlateQ's rows within the env-step bound (rtol
# 1e-5 / atol 1e-6).  A greedy slate may part only where the CPU's top two
# decomposed values were within REST_TIE of the largest.
REST_TOL = {"maml": 5e-5, "maml_rewards": 1e-7, "dt": 1e-5, "dt_flash": 1e-5,
            "slateq_loss": 2e-6, "slateq_params_in_steps": 1e-3}
REST_TIE = 1e-5
HOST_CALLS = 200   # wrapper calls timed on the host clock, no sync inside


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters, warmup=3):
    """Mean time of one call, from CUDA events around ``iters`` calls."""
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


def on_card(what):
    """Wait for the card; a fault of the work queued so far is raised
    naming ``what``, the last step queued."""
    try:
        torch.cuda.synchronize()
    except Exception as err:
        raise RuntimeError(f"the card faulted in or before: {what}") from err


def qkv(seed, b, s_q, s_kv, h, h_kv, d, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(device="cuda", dtype=dtype)
            for shape in ((b, s_q, h, d), (b, s_kv, h_kv, d),
                          (b, s_kv, h_kv, d))]


def randn(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        device="cuda", dtype=dtype)


def attention_bound(b, s_q, s_kv, h, h_kv, d, dtype, causal, products=2,
                    q_like=2, kv_like=2, stats=1):
    """(ms, "operations" | "bytes"): the least time for this call's work —
    2·d FLOPs per visible (row, key) pair for each of its ``products``, and
    each tensor read or written once: ``q_like`` of shape q, ``kv_like`` of
    shape k, ``stats`` fp32 [b, h, s_q].  The defaults are the forward's
    (S and P·V; q, o; k, v; lse)."""
    rows = np.arange(s_q) + (s_kv - s_q)
    pairs = (int(np.clip(rows + 1, 0, s_kv).sum()) if causal
             else s_q * s_kv)
    flops = 2 * products * b * h * d * pairs
    elt = torch.finfo(dtype).bits // 8
    nbytes = (elt * b * d * (q_like * s_q * h + kv_like * s_kv * h_kv)
              + 4 * stats * b * h * s_q)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def named(cases, name):
    return next(case for case in cases if case[0] == name)


def kernel_name(wrapper, dtype):
    """The CUDA kernel a wrapper launches for ``dtype``: the Hopper kernel
    for bf16, the scalar fp32 route's otherwise."""
    return f"{wrapper}_{'hopper' if dtype == torch.bfloat16 else 'fp32'}" \
        "_kernel"


def fwd_matches(o, lse, o_ref, lse_ref, dtype):
    """→ (agrees, max |ΔO|, max |ΔLSE|, largest tile error of O)."""
    from ray_tpu_torch.ops import tile_rel_err

    tol_o, tol_lse = TOL[dtype]
    err_o = (o.float() - o_ref.float()).abs()
    err_lse = float((lse - lse_ref).abs().max())
    tile = tile_rel_err(o, o_ref)
    ok = (bool(torch.all(err_o <= tol_o + tol_o * o_ref.float().abs()))
          and err_lse <= tol_lse and tile <= TILE_TOL[dtype]
          and bool(torch.isfinite(o).all()))
    return ok, float(err_o.max()), err_lse, tile


def device_ms(fn, match=None, calls=10, tries=3):
    """Device time (ms) of one call of ``fn``: the time of its kernels
    (those whose name holds ``match``, when given) from torch.profiler over
    ``calls`` calls back to back.  Unlike CUDA events around back-to-back
    calls, it does not grow when the host's time a call exceeds the
    kernels' (a short kernel behind a slow host).  A profiler session now
    and then records no device activity at all; after ``tries`` such
    sessions the time comes from CUDA events around the same calls, which
    is at least the device time, and a line says so."""
    fn()
    seen = set()
    for _ in range(tries):
        kernels = device_kernel_ms(lambda: [fn() for _ in range(calls)])
        total = sum(ms for name, ms in kernels.items()
                    if match is None or match in name)
        if total:
            return total / calls
        seen.update(kernels)
    if seen:   # device activity every so often, but never the named kernel
        raise AssertionError(f"the profiler saw no kernel named {match}: "
                             f"{sorted(seen)[:8]}")
    ms = cuda_ms(fn, iters=calls, warmup=0)
    log(f"  the profiler recorded no device activity in {tries} sessions: "
        f"{ms:.4f} ms a call from CUDA events instead")
    return ms


def time_fwd(card, ops, what, b, s, h, h_kv, d, dtype, causal=True):
    """Kernel, plain, library and host times of the forward at one shape
    (s_q = s_kv = s), beside its bound: kernel and library by CUDA events
    over back-to-back calls and by their kernels' device time."""
    q, k, v = qkv(1, b, s, s, h, h_kv, d, dtype)
    scale = d ** -0.5

    def kernel():
        return ops.flash_fwd(q, k, v, causal, scale)

    ms = cuda_ms(kernel, iters=50)
    kernel_device_ms = device_ms(kernel, kernel_name("flash_fwd", dtype))
    plain_ms = cuda_ms(
        lambda: ops.flash_attention_plain(q, k, v, causal, scale), iters=5,
        warmup=1)
    # yardstick only, never called by the port: at s_q = s_kv its top-left
    # causal mask is the same as the bottom-right one
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True)

    library_ms = cuda_ms(library, iters=50)
    library_device_ms = device_ms(library)
    # the wrapper's host time per call: checks, allocation, the tensor maps,
    # the launch; the card runs behind
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        ops.flash_fwd(q, k, v, causal, scale)
    host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    bound_ms, bound_by = attention_bound(b, s, s, h, h_kv, d, dtype, causal)
    log(f"  {what} shape (b={b} s={s} h={h}/{h_kv} causal={causal}) timing: "
        f"kernel {ms:.4f} ms ({kernel_device_ms:.4f} ms of device time), "
        f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
        f"{library_ms:.4f} ms ({library_device_ms:.4f} device; "
        f"{kernel_device_ms / library_device_ms:.2f}x), bound {bound_ms:.4f} "
        f"ms ({bound_by}); kernel at {100 * bound_ms / kernel_device_ms:.1f}%"
        f" of the bound; wrapper host time {host_us:.1f} us a call [{card}]")
    return {"ms": ms, "device_ms": kernel_device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_device_ms": library_device_ms, "host_us": host_us}


def phase_kernels(card, ops):
    log("== kernels: flash_fwd against flash_attention_plain on the card")
    main_err = None
    for name, b, s_q, s_kv, h, h_kv, d, dtype, causal in CASES:
        q, k, v = qkv(0, b, s_q, s_kv, h, h_kv, d, dtype)
        scale = d ** -0.5
        # a fault names its case and whether the kernel or the plain
        # version ran into it
        on_card(f"inputs of case {name}")
        o, lse = ops.flash_fwd(q, k, v, causal, scale)
        on_card(f"flash_fwd, case {name}")
        o_ref, lse_ref = ops.flash_attention_plain(q, k, v, causal, scale)
        on_card(f"flash_attention_plain, case {name}")
        ok, err_o, err_lse, tile = fwd_matches(o, lse, o_ref, lse_ref, dtype)
        tol_o, tol_lse = TOL[dtype]
        log(f"  {name:<10} b={b} s_q={s_q} s_kv={s_kv} h={h}/{h_kv} d={d} "
            f"{str(dtype)[6:]} causal={causal}: max|dO|={err_o:.3e} "
            f"(atol=rtol={tol_o:g}) max|dLSE|={err_lse:.3e} "
            f"(atol={tol_lse:g}); tile error {tile:.3e} "
            f"(<= {TILE_TOL[dtype]:g})")
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain "
                                 f"version in case {name}")
        if causal and s_q > s_kv:   # rows that see no key
            dead = s_q - s_kv
            if not (torch.all(o[:, :dead] == 0)
                    and torch.all(lse[:, :, :dead] == 0)):
                raise AssertionError("dead rows are not O = 0, LSE = 0")
        if dtype == torch.float32:   # no atomics: each output written once
            again = ops.flash_fwd(q, k, v, causal, scale)
            if not (torch.equal(o, again[0]) and torch.equal(lse, again[1])):
                raise AssertionError(f"flash_fwd is not deterministic in "
                                     f"case {name}")
            log("             O, LSE bitwise the same over two calls")
            del again
        faults = ops.planted_fwd_faults(ops.flash_fwd, q, k, v, o, causal,
                                        scale)
        if len(faults) < 3:     # a sequence within one tile
            faults.update(short_fwd_faults(ops, q, k, v, o, causal, scale))
        refused = []
        for what, bad in faults.items():
            if fwd_matches(bad, lse, o_ref, lse_ref, dtype)[0]:
                raise AssertionError(f"the check let a planted fault pass "
                                     f"in case {name}: {what}")
            refused.append(f"{what} {ops.tile_rel_err(bad, o_ref):.3g}")
        if len(refused) != 3:
            raise AssertionError(f"case {name} planted {len(refused)} of the "
                                 f"3 faults")
        log(f"             planted faults refused (tile error): "
            + "; ".join(refused))
        if name == "main":
            main_err = err_o
        del q, k, v, o, lse, o_ref, lse_ref

    by_shape = {}
    for what, case in TIMED_FWD.items():
        _, b, s_q, _, h, h_kv, d, dtype, causal = named(CASES, case)
        by_shape[what] = time_fwd(card, ops, what, b, s_q, h, h_kv, d, dtype,
                                  causal)
    serve = by_shape["serve"]
    return {"name": "flash_fwd", "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_fwd.cu",
            "kernel": "flash_fwd_hopper_kernel",
            "replaces": "ray_tpu/ops/flash_attention.py:94",
            "max_abs_err": main_err, "ms": serve["ms"],
            "plain_ms": serve["plain_ms"], "bound_ms": serve["bound_ms"],
            "bound_by": serve["bound_by"], "library_ms": serve["library_ms"],
            "by_shape": by_shape}


def short_fwd_faults(ops, q, k, v, o, causal, scale):
    """{what: O} of wrong forward kernels at a sequence shorter than a
    64-row tile, where `ops.planted_fwd_faults` finds no key tile to drop:
    the causal mask left off, and the first key's V dropped (every row
    sees it)."""
    faults = {}
    if causal:
        faults["the causal mask off"] = ops.flash_fwd(q, k, v, False,
                                                      scale)[0]
    v_cut = v.clone()
    v_cut[:, 0] = 0
    faults["the first key dropped"] = ops.flash_fwd(q, k, v_cut, causal,
                                                    scale)[0]
    return faults


def bwd_matches(got, want, dtype):
    """→ (agrees, largest tile error) of one of dQ, dK, dV."""
    from ray_tpu_torch.ops import tile_rel_err

    tol = BWD_TOL[dtype]
    tile = tile_rel_err(got, want)
    elementwise = torch.all((got.float() - want.float()).abs()
                            <= tol + tol * want.float().abs())
    return (bool(elementwise and torch.isfinite(got).all())
            and tile <= TILE_TOL[dtype]), tile


def delta_of(o, do):
    """δ as flash_bwd computes it before the two kernels."""
    return (do * o.float()).sum(-1).transpose(1, 2).contiguous()


def planted_faults(ops, q, k, v, o, lse, do, causal, scale, got):
    """{what: (0 dQ | 1 dK | 2 dV, tensor)}: results a wrong kernel could
    give, each of which the check must refuse.  Within one 64-key tile
    (the DT shapes, where zeroing the last tile zeroes everything) also
    the causal mask left off and the first key's gradients dropped."""
    s_q, h, s_kv, h_kv = q.shape[1], q.shape[2], k.shape[1], k.shape[2]
    faults = {}
    if s_kv <= 64:
        if causal:
            delta = delta_of(o, do)
            faults["dQ, the causal mask off"] = (0, ops.flash_bwd_dq(
                q, k, v, do, lse, delta, False, scale))
            faults["dV, the causal mask off"] = (2, ops.flash_bwd_dkv(
                q, k, v, do, lse, delta, False, scale)[1])
        bad = got[1].clone()
        bad[:, 0] = 0
        faults["dK, the first key dropped"] = (1, bad)
    for i, what, s in ((0, "dQ, last q tile", s_q),
                       (1, "dK, last key tile", s_kv),
                       (2, "dV, last key tile", s_kv)):
        bad = got[i].clone()
        bad[:, (s - 1) // 64 * 64:] = 0
        faults[what + " zeroed"] = (i, bad)
    if h > h_kv:   # GQA: the first query head of each group left out
        do_cut = do.clone()
        do_cut[:, :, ::h // h_kv] = 0
        dk, dv = ops.flash_bwd_dkv(q, k, v, do_cut, lse, delta_of(o, do_cut),
                                   causal, scale)
        faults["dK, a head of each group left out"] = (1, dk)
        faults["dV, a head of each group left out"] = (2, dv)
    return faults


def phase_bwd_kernels(card, ops):
    log("== kernels: flash_bwd_dq and flash_bwd_dkv against "
        "flash_attention_bwd_plain on the card")
    main_err = {}
    for name, b, s_q, s_kv, h, h_kv, d, dtype, causal in BWD_CASES:
        q, k, v = qkv(2, b, s_q, s_kv, h, h_kv, d, dtype)
        do = randn(3, (b, s_q, h, d), dtype)
        scale = d ** -0.5
        o, lse = ops.flash_fwd(q, k, v, causal, scale)
        got = ops.flash_bwd(q, k, v, o, lse, do, causal, scale)
        on_card(f"flash_fwd and flash_bwd, case {name}")
        want = ops.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                             scale)
        on_card(f"flash_attention_bwd_plain, case {name}")
        errs, tiles = [], []
        for g, w in zip(got, want):
            ok, tile = bwd_matches(g, w, dtype)
            errs.append(float((g.float() - w.float()).abs().max()))
            tiles.append(tile)
            if not ok:
                raise AssertionError(f"flash_bwd disagrees with its plain "
                                     f"version in case {name}: max|err| "
                                     f"{errs[-1]:.3e}, tile error {tile:.3e}")
        log(f"  {name:<10} b={b} s_q={s_q} s_kv={s_kv} h={h}/{h_kv} d={d} "
            f"{str(dtype)[6:]} causal={causal}: max|ddQ|={errs[0]:.3e} "
            f"max|ddK|={errs[1]:.3e} max|ddV|={errs[2]:.3e} "
            f"(atol=rtol={BWD_TOL[dtype]:g}); tile error dQ {tiles[0]:.3e} "
            f"dK {tiles[1]:.3e} dV {tiles[2]:.3e} "
            f"(<= {TILE_TOL[dtype]:g})")
        if causal and s_q > s_kv and not torch.all(got[0][:, :s_q - s_kv]
                                                   == 0):
            raise AssertionError("dead rows have a gradient")
        if dtype == torch.float32:   # no atomics: each output written once
            again = ops.flash_bwd(q, k, v, o, lse, do, causal, scale)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"flash_bwd is not deterministic in "
                                     f"case {name}")
            log("             dQ, dK, dV bitwise the same over two calls")
            del again
        refused = []
        for what, (i, bad) in planted_faults(ops, q, k, v, o, lse, do, causal,
                                             scale, got).items():
            ok, tile = bwd_matches(bad, want[i], dtype)
            if ok:
                raise AssertionError(f"the check let a planted fault pass in "
                                     f"case {name}: {what}")
            refused.append(f"{what} {tile:.3g}")
        log(f"             planted faults refused (tile error): "
            + "; ".join(refused))
        if name == "main":
            main_err = {"flash_bwd_dq": errs[0],
                        "flash_bwd_dkv": max(errs[1:])}
        del q, k, v, do, o, lse, got, want

    name, b, s_q, s_kv, h, h_kv, d, dtype, causal = BWD_CASES[0]
    q, k, v = qkv(5, b, s_q, s_kv, h, h_kv, d, dtype)
    do = randn(6, (b, s_q, h, d), dtype)
    scale = d ** -0.5
    o, lse = ops.flash_fwd(q, k, v, causal, scale)
    # no atomics: each output tile is written once, so two calls agree
    first = ops.flash_bwd(q, k, v, o, lse, do, causal, scale)
    second = ops.flash_bwd(q, k, v, o, lse, do, causal, scale)
    same = [bool(torch.equal(x, y)) for x, y in zip(first, second)]
    log(f"  {name}: dQ, dK, dV bitwise the same over two calls: {same}")
    if not all(same):
        raise AssertionError("flash_bwd is not deterministic")
    del q, k, v, do, o, lse, first, second
    by_shape = {what: time_bwd(card, ops, what, *named(BWD_CASES, case)[1:])
                for what, case in TIMED_BWD.items()}
    rows = []
    for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
        main = by_shape["train"]
        rows.append({"name": kname, "route": "cuda",
                     "source": "ray_tpu_torch/csrc/flash_bwd.cu",
                     "kernel": f"{kname}_hopper_kernel",
                     "replaces": ("ray_tpu/ops/flash_attention.py:202"
                                  if kname == "flash_bwd_dq" else
                                  "ray_tpu/ops/flash_attention.py:241"),
                     "max_abs_err": main_err[kname], **main[kname],
                     "library_ms": main["library_ms"],
                     "bwd_whole_ms": main["whole_ms"],
                     "by_shape": {what: dict(
                         t[kname], library_ms=t["library_ms"],
                         library_wall_ms=t["library_wall_ms"],
                         bwd_whole_ms=t["whole_ms"], delta_ms=t["delta_ms"])
                         for what, t in by_shape.items()}})
    return rows


def time_bwd(card, ops, what, b, s_q, s_kv, h, h_kv, d, dtype, causal):
    """Times of the backward at one shape: flash_bwd as a whole, delta
    alone, SDPA's backward (its kernels' device time, and a call's time back
    to back), and each kernel and its plain version beside its bound.
    → {"whole_ms", "delta_ms", "library_ms", "library_wall_ms", kernel
    name: {"ms", "plain_ms", "bound_ms", "bound_by"}}."""
    q, k, v = qkv(5, b, s_q, s_kv, h, h_kv, d, dtype)
    do = randn(6, (b, s_q, h, d), dtype)
    scale = d ** -0.5
    o, lse = ops.flash_fwd(q, k, v, causal, scale)
    args = (q, k, v, do, lse, delta_of(o, do), causal, scale)
    # yardstick only, never called by the port: the backward of
    # scaled_dot_product_attention (dQ, dK and dV in one call); at s_q =
    # s_kv its top-left causal mask is the bottom-right one
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()

    def library():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    # the autograd call spends more host time than its kernels take, so
    # CUDA events around back-to-back calls time the host: its kernels'
    # device time comes from the profiler
    times = {"library_wall_ms": cuda_ms(library, iters=20),
             "library_ms": device_ms(library, calls=5)}
    times["whole_ms"] = cuda_ms(
        lambda: ops.flash_bwd(q, k, v, o, lse, do, causal, scale), iters=20)
    times["delta_ms"] = cuda_ms(lambda: delta_of(o, do), iters=20)
    log(f"  {what} shape (b={b} s={s_q} h={h}/{h_kv} causal={causal}): "
        f"flash_bwd as a whole (delta + dQ + dK/dV) {times['whole_ms']:.4f} "
        f"ms, delta alone {times['delta_ms']:.4f} ms; "
        f"scaled_dot_product_attention backward {times['library_ms']:.4f} "
        f"ms of device time ({times['whole_ms'] / times['library_ms']:.2f}x;"
        f" {times['library_wall_ms']:.4f} ms a call back to back) [{card}]")
    for kernel, plain, counts in (
            (ops.flash_bwd_dq, ops.flash_bwd_dq_plain,
             dict(products=3, q_like=3, kv_like=2, stats=2)),
            (ops.flash_bwd_dkv, ops.flash_bwd_dkv_plain,
             dict(products=4, q_like=2, kv_like=4, stats=2))):
        kname = kernel.__name__
        ms = cuda_ms(lambda: kernel(*args), iters=20)
        dev = device_ms(lambda: kernel(*args), kernel_name(kname, dtype))
        plain_ms = cuda_ms(lambda: plain(*args), iters=3, warmup=1)
        bound_ms, bound_by = attention_bound(b, s_q, s_kv, h, h_kv, d,
                                             dtype, causal, **counts)
        log(f"  {kname} {what} shape timing: kernel {ms:.4f} ms ({dev:.4f} "
            f"ms of device time), plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention backward (dQ+dK+dV) "
            f"{times['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}); kernel at {100 * bound_ms / dev:.1f}% of the "
            f"bound [{card}]")
        times[kname] = {"ms": ms, "device_ms": dev, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by}
    return times


def phase_slice(card, flash_fwd):
    from ray_tpu_torch.models import (TransformerConfig, generate,
                                      init_kv_cache, prefill)
    from ray_tpu_torch.serve import DecodeSessionCore

    log("== slice: llama-1b whole-prompt serving through "
        "DecodeSessionCore(engine=False)")
    cfg = TransformerConfig.llama("1b", param_dtype=torch.bfloat16)
    max_len = max(PROMPTS) + NEXT_STEPS + 16
    core = DecodeSessionCore(cfg, max_len=max_len, seed=0, engine=False)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPTS]
    # one short request first, so that no timed request pays the first
    # use of a matmul shape
    warm = core.handle({"op": "start", "prompt": prompts[-1]})
    core.handle({"op": "next", "sid": warm["sid"]})
    core.handle({"op": "end", "sid": warm["sid"]})

    flash_fwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls = {}
    for prompt in prompts:
        before = flash_fwd.launches
        t0 = time.perf_counter()
        start = core.handle({"op": "start", "prompt": prompt})  # .tolist() syncs
        ttft = (time.perf_counter() - t0) * 1e3
        if flash_fwd.launches - before != cfg.n_layers:
            raise AssertionError(f"start launched the kernel "
                                 f"{flash_fwd.launches - before} times, "
                                 f"expected {cfg.n_layers}")
        tokens = list(start["token"])
        t0 = time.perf_counter()
        for _ in range(NEXT_STEPS):
            tokens += core.handle({"op": "next", "sid": start["sid"]})["token"]
        per_tok = (time.perf_counter() - t0) * 1e3 / NEXT_STEPS
        if core.handle({"op": "end", "sid": start["sid"]}) != {"ended": True}:
            raise AssertionError("end did not end the session")
        if not all(0 <= t < cfg.vocab_size for t in tokens):
            raise AssertionError(f"token out of range: {tokens}")
        walls[len(prompt)] = (ttft, per_tok)
        log(f"  request prompt={len(prompt)}: TTFT {ttft:.2f} ms, "
            f"{per_tok:.2f} ms/token over {NEXT_STEPS} next "
            f"({len(tokens)} tokens) [{card}]")
    before = flash_fwd.launches
    gen = generate(core.params, rng.integers(0, cfg.vocab_size, (2, 128)),
                   cfg=cfg, max_new_tokens=8)
    torch.cuda.synchronize()
    if (tuple(gen.shape) != (2, 8) or int(gen.min()) < 0
            or int(gen.max()) >= cfg.vocab_size
            or flash_fwd.launches - before != cfg.n_layers):
        raise AssertionError(f"generate gave {gen.tolist()} with "
                             f"{flash_fwd.launches - before} launches")
    launches = flash_fwd.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"  generate B=2: {gen.tolist()}")
    log(f"  flash_fwd launches on the main path: {launches}; peak memory "
        f"{peak_gib:.2f} GiB [{card}]")

    # the full-width check: the same model with reference attention
    prompt = torch.tensor([prompts[0]], device="cuda")
    logits, _ = prefill(core.params, prompt, cfg,
                        init_kv_cache(cfg, 1, len(prompts[0])))
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    ref, _ = prefill(core.params, prompt, ref_cfg,
                     init_kv_cache(ref_cfg, 1, len(prompts[0])))
    cos = float(torch.nn.functional.cosine_similarity(logits, ref, dim=-1))
    diff = float((logits - ref).abs().max())
    agree = bool(torch.equal(logits.argmax(-1), ref.argmax(-1)))
    log(f"  2048-token prefill logits, flash vs reference attention: "
        f"max|diff|={diff:.4e} argmax agree={agree} cosine={cos:.6f} "
        f"(must be >= 0.99)")
    if not (torch.isfinite(logits).all() and cos >= 0.99):
        raise AssertionError("flash prefill logits disagree with reference")

    # where the time goes: device time by kernel for one 2048-token start
    # and one next, against the unprofiled wall times measured above
    start_req = {"op": "start", "prompt": prompts[0]}
    sid = []
    for what, fn, wall in (
            ("start (2048-token prefill)",
             lambda: sid.append(core.handle(start_req)["sid"]),
             walls[PROMPTS[0]][0]),
            ("next (decode step)",
             lambda: core.handle({"op": "next", "sid": sid[0]}),
             walls[PROMPTS[0]][1])):
        kernels = device_kernel_ms(fn)
        if not kernels:
            log(f"  {what}: device time not measured (the profiler "
                f"recorded no device activity)")
            continue
        busy = sum(kernels.values())
        log(f"  {what}: device busy {busy:.2f} ms of {wall:.2f} ms wall "
            f"({100 * busy / wall:.1f}%), {len(kernels)} kernel names "
            f"[{card}]")
        for name, ms in top_kernels(kernels, 6):
            log(f"      {ms:8.3f} ms  {name[:100]}")
    core.handle({"op": "end", "sid": sid[0]})
    return launches


def top2_gap(logits):
    """(top - second) / |top| of one row of logits: how near a tie the
    argmax was."""
    top = torch.topk(logits.float(), 2).values
    return float((top[0] - top[1]) / top[0].abs())


def eager_gap(params, cfg, prompt, stream, i, max_len=ENGINE_MAX_LEN):
    """The engine=False path's top-2 gap where it chose stream[i]: the
    prompt through `prefill`, then stream[:i] through `decode_step`."""
    from ray_tpu_torch.models import decode_step, init_kv_cache, prefill

    cache = init_kv_cache(cfg, 1, max_len)
    logits, cache = prefill(params, torch.tensor([prompt], device="cuda"),
                            cfg, cache)
    for tok in stream[:i]:
        logits, cache = decode_step(params, torch.tensor([tok], device="cuda"),
                                    cache, cfg)
    return top2_gap(logits[0])


def replay_gap(params, cfg, prompt, stream, i, max_len=ENGINE_MAX_LEN):
    """The top-2 gap where a replay of prompt + stream[:i] through the
    engine's chunk programs (`resume_prefill`) chooses stream[i]."""
    from ray_tpu_torch.models import init_kv_cache, resume_prefill

    logits, _ = resume_prefill(
        params, torch.tensor([prompt + stream[:i]], device="cuda"), cfg,
        init_kv_cache(cfg, 1, max_len), chunk=ENGINE_CHUNK)
    return top2_gap(logits[0])


def same_or_tie(what, got, want, gap_at, tie):
    """Streams equal, or equal up to a position where the reference's top
    two logits are within ``tie`` of each other (a tie within the dtype's
    rounding), which is printed either way.  → the first differing index
    or None."""
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
    if first is None and len(got) == len(want):
        log(f"  {what}: identical ({len(got)} tokens)")
        return None
    if first is None:
        raise AssertionError(f"{what}: streams of {len(got)} and "
                             f"{len(want)} tokens")
    gap = gap_at(first)
    log(f"  {what}: first differs at token {first} of {len(want)} "
        f"({got[first]} against {want[first]}); the reference's top-2 gap "
        f"there {gap:.3e} of the top logit (a tie if < {tie:g})")
    if gap >= tie:
        raise AssertionError(f"{what}: streams differ at token {first}, "
                             f"not at a tie")
    return first


def drain(core, sid, toks, want, chunk=16):
    """next_chunk(max_tokens=chunk) until ``want`` tokens; the session's
    errors raise."""
    while len(toks) < want:
        out = core.handle({"op": "next_chunk", "sid": sid,
                           "max_tokens": min(chunk, want - len(toks))})
        if "error" in out:
            raise AssertionError(f"session {sid}: {out['error']}")
        if out["done"] and not out["tokens"]:
            raise AssertionError(f"session {sid} finished after "
                                 f"{len(toks)} of {want} tokens")
        toks += out["tokens"]
    return toks


def serve_streams(core, prompts, want):
    """Start every prompt, then drain each to ``want`` tokens and end it."""
    starts = [core.handle({"op": "start", "prompt": p}) for p in prompts]
    streams = [drain(core, r["sid"], list(r["token"]), want) for r in starts]
    for r in starts:
        core.handle({"op": "end", "sid": r["sid"]})
    return streams


def eager_streams(core, prompts, want):
    out = []
    for p in prompts:
        r = core.handle({"op": "start", "prompt": p})
        toks = list(r["token"])
        while len(toks) < want:
            toks += core.handle({"op": "next", "sid": r["sid"]})["token"]
        core.handle({"op": "end", "sid": r["sid"]})
        out.append(toks)
    return out


def prefill_chunks(n, chunk=ENGINE_CHUNK):
    """Chunk programs an admission of n prompt tokens runs: chunks of
    ``chunk``, then 1-token tails."""
    return n // chunk + n % chunk


class Clients:
    """Client threads, each running fn(i); errors are kept, not lost."""

    def __init__(self, fn, n):
        self.errors, self.results = [], [None] * n

        def run(i):
            try:
                self.results[i] = fn(i)
            except Exception as e:   # reported by join()
                self.errors.append(f"client {i}: {e!r}")

        self.threads = [threading.Thread(target=run, args=(i,))
                        for i in range(n)]
        for t in self.threads:
            t.start()

    def join(self, timeout=300):
        for t in self.threads:
            t.join(timeout=timeout)
            if t.is_alive():
                raise AssertionError("a client thread did not finish")
        if self.errors:
            raise AssertionError("; ".join(self.errors))
        return self.results


def wait_for(cond, what, timeout=120):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def quiet(core):
    """Wait until the engine holds no slot: an ended session leaves its
    slot at the loop's next turn, after the last step that counted it, so
    the engine's counters (steps, replays) are then settled."""
    wait_for(lambda: core.handle({"op": "stats"})["engine"]
             ["occupied_slots"] == 0, "an idle engine")


class GraphState:
    """The engine's decode step captured as a CUDA graph over a slot cache
    of random K/V with the slots at ``pos`` (all active), and the same
    step run eagerly from the same state."""

    def __init__(self, cfg, params, max_len, pos):
        from ray_tpu_torch.models import init_slot_cache
        from ray_tpu_torch.serve.step_graph import FusedDecodeStep

        self.cfg, self.params = cfg, params
        slots = len(pos)
        self.cache = init_slot_cache(cfg, slots, max_len)
        gen = torch.Generator(device="cuda").manual_seed(1)
        for name in ("k", "v"):
            self.cache[name].copy_(torch.randn(
                self.cache[name].shape, generator=gen, device="cuda",
                dtype=cfg.dtype))
        self.cache["pos"].copy_(torch.tensor(pos))
        self.saved = {name: t.clone() for name, t in self.cache.items()}
        self.tokens = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                        slots)
        self.active = np.ones(slots, bool)
        self.step = FusedDecodeStep(params, self.cache, cfg)
        t0 = time.perf_counter()
        self.step.capture()
        torch.cuda.synchronize()
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def restore(self):
        for name, t in self.saved.items():
            self.cache[name].copy_(t)

    def compare(self):
        """One replay against one eager step from the saved state → (tokens
        equal, pos equal, the graph's pos, max |Δlogits|, that over
        max |logits|)."""
        from ray_tpu_torch.models import decode_step_slots

        self.restore()
        graph_toks = self.step.run(self.tokens, self.active)
        graph_logits = self.step.logits.clone()
        graph_pos = self.cache["pos"].tolist()
        self.restore()
        tok = torch.tensor(self.tokens, device="cuda")
        act = torch.tensor(self.active, device="cuda")
        logits, new = decode_step_slots(self.params, tok, self.cache, act,
                                        self.cfg)
        eager_toks = torch.where(act, logits.argmax(-1), tok).tolist()
        diff = float((graph_logits - logits).abs().max())
        return (graph_toks.tolist() == eager_toks,
                graph_pos == new["pos"].tolist(), graph_pos, diff,
                diff / float(logits.abs().max()))


def ttft_ms(core, prompt):
    """Host time of one start, which returns once the prompt is
    prefilled; the session is ended after it."""
    t0 = time.perf_counter()
    r = core.handle({"op": "start", "prompt": prompt})
    ms = (time.perf_counter() - t0) * 1e3
    core.handle({"op": "end", "sid": r["sid"]})
    return ms


class Streams:
    """``n`` client threads, each draining one stream of ``prompt`` until
    `stop`; built once every stream holds a slot."""

    def __init__(self, core, prompt, n):
        self.halt = threading.Event()

        def streaming(i):
            r = core.handle({"op": "start", "prompt": prompt})
            got_n = 1
            while not self.halt.is_set():
                got = core.handle({"op": "next_chunk", "sid": r["sid"],
                                   "max_tokens": 16})
                if "error" in got or got["done"]:
                    raise AssertionError(f"stream {i} ended early: {got}")
                got_n += len(got["tokens"])
            core.handle({"op": "end", "sid": r["sid"]})
            return got_n

        self.clients = Clients(streaming, n)
        wait_for(lambda: core.handle({"op": "stats"})["engine"]
                 ["occupied_slots"] == n, "every stream in a slot")

    def stop(self):
        self.halt.set()
        self.clients.join()


def tokens_per_s(core):
    """(tokens/s, ms per engine step) over a THROUGHPUT_WINDOW_S window of
    the engine's counters."""
    a = core.handle({"op": "stats"})["engine"]
    t0 = time.perf_counter()
    time.sleep(THROUGHPUT_WINDOW_S)
    b = core.handle({"op": "stats"})["engine"]
    dt = time.perf_counter() - t0
    return ((b["tokens"] - a["tokens"]) / dt,
            dt * 1e3 / max(1, b["steps"] - a["steps"]))


# the serve series the engine feeds (core.runtime_metrics) and the stats()
# count each must equal
SERVE_SERIES = {
    "ray_tpu_serve_tokens_total": lambda st: st["tokens"],
    "ray_tpu_serve_prefill_chunks_total": lambda st: st["prefill_chunks"],
    "ray_tpu_serve_prefix_hits_total":
        lambda st: st["prefix"]["applied_hits"],
    "ray_tpu_serve_prefix_tokens_reused_total":
        lambda st: st["prefix"]["tokens_reused"],
    "ray_tpu_serve_spec_tokens_proposed_total":
        lambda st: st["spec"]["proposed"],
    "ray_tpu_serve_spec_tokens_accepted_total":
        lambda st: st["spec"]["accepted"],
}


def engine_hooks(card, core, what):
    """The serve series of a stopped (or quiet) engine against its stats(),
    and the count of its spans by kind; fails where a series differs."""
    from ray_tpu_torch import metrics
    from ray_tpu_torch.util import tracing

    name = core.engine.name
    st = core.handle({"op": "stats"})["engine"]
    text = metrics.prometheus_text()
    got, want = {}, {}
    for series, count in SERVE_SERIES.items():
        line = f'{series}{{deployment="{name}"}} '
        found = [ln for ln in text.splitlines() if ln.startswith(line)]
        got[series] = float(found[0][len(line):]) if found else 0.0
        want[series] = float(count(st))
    spans = {}
    for e in tracing.span_events():
        if e["name"].endswith(f"::{name}"):
            kind = e["name"].split("::")[0]
            spans[kind] = spans.get(kind, 0) + 1
    log(f"  {what}: serve series {json.dumps(got)}; spans kept "
        f"{json.dumps(spans)} [{card}]")
    if got != want:
        raise AssertionError(f"{what}: the serve series {got} differ from "
                             f"stats() {want}")
    if not spans.get("serve_prefill_chunk") or not (
            spans.get("serve_decode_step") or spans.get("serve_spec_verify")):
        raise AssertionError(f"{what}: no prefill-chunk or step spans")
    return {"series": got, "spans": spans}


def engine_graph_checks(card, cfg, params, out):
    """Graph against eager from one state, step times, device busy shares,
    chunk and speculative iteration times."""
    from ray_tpu_torch.models import (draft_propose_slots, init_kv_cache,
                                      prefill_chunk, verify_step_slots)

    slots, max_len = ENGINE_SLOTS, ENGINE_MAX_LEN
    state = GraphState(cfg, params, max_len, [5, 100, 517, 1000, 1499, 1800,
                                              2046, max_len - 1])
    step, cache, saved = state.step, state.cache, state.saved
    tokens, active, restore = state.tokens, state.active, state.restore
    same_toks, same_pos, graph_pos, diff, rel = state.compare()
    log(f"  graph against eager from one state (8 slots active, pos "
        f"{saved['pos'].tolist()}): tokens equal {same_toks}, pos equal "
        f"{same_pos} ({graph_pos}), logits max|diff| "
        f"{diff:.3e}, {rel:.3e} of max|logits| (must be <= 1e-2); capture "
        f"(2 warm-up steps + capture) {state.capture_ms:.1f} ms")
    if not (same_toks and same_pos and rel <= 1e-2):
        raise AssertionError("the graph replay and the eager step disagree")
    out["graph_vs_eager_rel"] = rel
    out["capture_ms"] = state.capture_ms

    # step times, eager against graph: device time from CUDA events over
    # back-to-back steps, host time of one step with its token read
    for occ in (1, slots):
        mask = np.zeros(slots, bool)
        mask[:occ] = True
        restore()
        step.load(tokens, mask)
        graph_ms = cuda_ms(step.graph.replay, iters=100)
        eager_ms = cuda_ms(step._step, iters=20)
        walls = {}
        for what, fn in (("graph", lambda: step.run(tokens, mask)),
                         ("eager", lambda: (step.load(tokens, mask),
                                            step._step()[1].tolist()))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            walls[what] = (time.perf_counter() - t0) * 1e3 / 50
        log(f"  decode step, occupancy {occ} of {slots}: graph {graph_ms:.4f}"
            f" ms device, {walls['graph']:.4f} ms host with its token read; "
            f"eager {eager_ms:.4f} ms device, {walls['eager']:.4f} ms host "
            f"[{card}]")
        out[f"step_occ{occ}"] = {"graph_ms": graph_ms, "eager_ms": eager_ms,
                                 "graph_wall_ms": walls["graph"],
                                 "eager_wall_ms": walls["eager"]}

    # where the step's time goes: one replay and one eager step, profiled
    restore()
    for what, fn, wall in (
            ("graph replay", lambda: step.run(tokens, active),
             out[f"step_occ{slots}"]["graph_wall_ms"]),
            ("eager step", lambda: step._step()[1].tolist(),
             out[f"step_occ{slots}"]["eager_wall_ms"])):
        kernels = device_kernel_ms(fn)
        if not kernels:
            log(f"  {what}: device time not measured (the profiler recorded "
                f"no device activity)")
            continue
        busy = sum(kernels.values())
        out[f"busy_{what.split()[0]}"] = {"busy_ms": busy, "wall_ms": wall}
        log(f"  {what}: device busy {busy:.3f} ms of {wall:.3f} ms wall "
            f"({100 * busy / wall:.1f}%), {len(kernels)} kernel names "
            f"[{card}]")
        for name, ms in top_kernels(kernels, 6):
            log(f"      {ms:8.3f} ms  {name[:100]}")

    ops, launched = host_ops(lambda: step._step()[1].tolist())
    log(f"  eager step: {ops} PyTorch ops on the host, {launched} kernels "
        f"on the card")
    out["eager_step_ops"] = {"ops": ops, "kernels": launched}

    # one prefill chunk ([1, 32] and a [1, 1] tail) at pos 1000
    pcache = init_kv_cache(cfg, 1, max_len)
    for width in (ENGINE_CHUNK, 1):
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (1, width))).cuda()
        at = dict(pcache, pos=1000)
        ms = cuda_ms(lambda: prefill_chunk(params, toks, at, cfg), iters=20)
        ops, launched = host_ops(lambda: prefill_chunk(params, toks, at,
                                                       cfg))
        log(f"  prefill chunk [1, {width}] at pos 1000: {ms:.4f} ms, {ops} "
            f"PyTorch ops on the host, {launched} kernels [{card}]")
        out[f"chunk{width}_ms"] = ms
    del pcache

    # one speculative iteration (shared draft, spec_k 4) over 8 slots, as
    # the engine runs it: eager draft and verify, one token read
    restore()
    dcache = {name: saved[name].clone() for name in ("k", "v")}
    k = 4

    def spec_iteration():
        step.load(tokens, active)
        props, _ = draft_propose_slots(
            params, step.tok, dict(dcache, pos=cache["pos"]), step.active,
            cfg, k)
        props = props[:, :k - 1]
        fed = torch.cat([step.tok[:, None], props], dim=1)
        greedy, acc, _ = verify_step_slots(params, fed, props, cache,
                                           step.active, cfg)
        return torch.cat([greedy, acc[:, None]], dim=1).cpu()

    spec_iteration()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        spec_iteration()
    spec_ms = (time.perf_counter() - t0) * 1e3 / 10
    kernels = device_kernel_ms(spec_iteration)
    busy = sum(kernels.values()) if kernels else None
    out["spec_iteration"] = {"wall_ms": spec_ms, "busy_ms": busy}
    log(f"  speculative iteration (draft 4 steps + verify 4 wide, eager, 8 "
        f"slots): {spec_ms:.3f} ms wall; device busy "
        + (f"{busy:.3f} ms, host share {100 * (1 - busy / spec_ms):.1f}%"
           if busy else "not measured") + f" [{card}]")
    del step, cache, saved, dcache, state


def phase_engine(card, ops):
    from ray_tpu_torch.models import (TransformerConfig, count_params,
                                      init_params)
    from ray_tpu_torch.serve import DecodeEngineConfig, DecodeSessionCore
    from ray_tpu_torch.util import fault_injection

    log("== engine: llama-1b through the continuous-batching engine, the "
        "decode step a CUDA graph")
    kernels = (ops.flash_fwd, ops.flash_bwd_dq, ops.flash_bwd_dkv)
    out = {}
    ecfg = DecodeEngineConfig(max_slots=ENGINE_SLOTS,
                              prefill_chunk_tokens=ENGINE_CHUNK)
    rng = np.random.default_rng(0)

    # ---- fp32: the engine against the engine=False core, and speculating
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    cfg32 = TransformerConfig.llama("1b", dtype=torch.float32,
                                    param_dtype=torch.float32)
    params32 = init_params(cfg32, torch.Generator(device="cuda").manual_seed(
        0), "cuda")
    prompts = [rng.integers(0, cfg32.vocab_size, n).tolist()
               for n in STREAM_PROMPTS]
    log(f"  fp32 streams: prompts of {STREAM_PROMPTS} tokens, "
        f"{STREAM_TOKENS} tokens each")
    streams = {}
    spec = dataclasses.replace(ecfg, spec_draft="shared", spec_k=4)
    out["hooks"] = {}
    for what, engine in (
            ("engine", ecfg),
            ("speculating", spec),
            # the chaos site armed to fail every speculative iteration:
            # plain steps after spec_fail_disable strikes, the same stream
            ("spec_verify armed", spec),
            ("engine=False", False)):
        core = DecodeSessionCore(cfg32, max_len=ENGINE_MAX_LEN,
                                 params=params32, engine=engine)
        if engine is not False:
            core.engine.name = f"fp32-{what.replace(' ', '-')}"
        if what == "spec_verify armed":
            fault_injection.arm([{
                "site": "serve.spec_verify", "action": "error",
                "match": {"regex": f"^{core.engine.name}$"}}])
        t0 = time.perf_counter()
        try:
            streams[what] = (eager_streams if engine is False else
                             serve_streams)(core, prompts, STREAM_TOKENS)
        finally:
            fault_injection.disarm()
        wall = time.perf_counter() - t0
        if engine is not False:
            core.engine.shutdown()
            core.engine._thread.join(timeout=30)
            st = core.handle({"op": "stats"})["engine"]
            log(f"  {what}: {st['steps']} engine iterations, "
                f"{st['graph_replays']} graph replays, spec {st['spec']}, "
                f"{wall:.2f} s")
            out["hooks"][what] = engine_hooks(card, core, what)
            if what == "speculating":
                out["fp32_spec_acceptance"] = st["spec"]["acceptance"]
                log(f"  speculating: acceptance {st['spec']['acceptance']} "
                    f"(shared draft: near 1.0 expected)")
            if what == "spec_verify armed" and not (
                    st["spec"]["fallbacks"] >= 1 and st["spec"]["disabled"]):
                raise AssertionError("the armed chaos site did not make the "
                                     "engine fall back to plain steps")
    for i, prompt in enumerate(prompts):
        for what, got, want in (
                ("engine against engine=False", streams["engine"][i],
                 streams["engine=False"][i]),
                ("speculating against the engine", streams["speculating"][i],
                 streams["engine"][i]),
                ("spec_verify armed against speculating",
                 streams["spec_verify armed"][i],
                 streams["speculating"][i])):
            # the gap is the engine=False path's along the reference stream
            same_or_tie(f"prompt {len(prompt)}: {what}", got, want,
                        functools.partial(eager_gap, params32, cfg32, prompt,
                                          want), TIE_FP32)
    # nothing may keep the fp32 weights: the bf16 runs' peak memory is
    # taken from here on
    del core, params32
    torch.cuda.empty_cache()

    # ---- bf16: graph against eager, step, chunk and speculative times
    cfg = TransformerConfig.llama("1b", param_dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    engine_graph_checks(card, cfg, params, out)
    torch.cuda.empty_cache()

    # ---- load: 12 sessions from client threads over 8 slots.  The main
    # path of this phase (load, resume, throughput, TTFT) runs between the
    # counters set to 0 here and read at the phase's end.
    for kernel in kernels:
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    core = DecodeSessionCore(cfg, max_len=ENGINE_MAX_LEN, params=params,
                             engine=ecfg)
    core.engine.name = "bf16-load"
    prefix = rng.integers(0, cfg.vocab_size, SHARED_PREFIX).tolist()
    load_prompts = ([prefix + rng.integers(0, cfg.vocab_size, n).tolist()
                     for n in SHARED_SUFFIXES]
                    + [rng.integers(0, cfg.vocab_size, n).tolist()
                       for n in LOAD_PROMPTS])
    first = core.handle({"op": "start", "prompt": load_prompts[0]})
    eng = core.engine
    wait_for(lambda: eng.sessions[first["sid"]].slot is not None,
             "the first sharer's slot")

    def session(i):
        r = first if i == 0 else core.handle({"op": "start",
                                              "prompt": load_prompts[i]})
        toks = drain(core, r["sid"], list(r["token"]), LOAD_TOKENS + 1)
        core.handle({"op": "end", "sid": r["sid"]})
        return toks

    t0 = time.perf_counter()
    load_streams = Clients(session, len(load_prompts)).join()
    load_s = time.perf_counter() - t0
    quiet(core)
    st = core.handle({"op": "stats"})["engine"]
    want_chunks = sum(prefill_chunks(len(p) - (SHARED_PREFIX if 0 < i < len(
        SHARED_SUFFIXES) else 0)) for i, p in enumerate(load_prompts))
    in_range = all(0 <= t < cfg.vocab_size for s in load_streams for t in s)
    launches = {k.__name__: k.launches for k in kernels}
    log(f"  load: {len(load_prompts)} sessions over {ENGINE_SLOTS} slots "
        f"(prompts {[len(p) for p in load_prompts]}), {LOAD_TOKENS} tokens "
        f"each after the first, in {load_s:.2f} s: {st['tokens']} tokens "
        f"decoded in {st['steps']} steps ({st['graph_replays']} graph "
        f"replays), {st['prefill_chunks']} prefill chunks (reckoned "
        f"{want_chunks}), prefix {st['prefix']}, tokens in range "
        f"{in_range}, kernel launches {launches} [{card}]")
    if not (in_range and all(len(s) == LOAD_TOKENS + 1
                             for s in load_streams)):
        raise AssertionError("a load session gave a wrong stream")
    if st["prefix"]["applied_hits"] != len(SHARED_SUFFIXES) - 1 or \
            st["prefix"]["tokens_reused"] != \
            SHARED_PREFIX * (len(SHARED_SUFFIXES) - 1):
        raise AssertionError("the sharers were not seeded from the prefix")
    if st["prefill_chunks"] != want_chunks:
        raise AssertionError("prefill chunks differ from the reckoning")
    if any(launches.values()):
        raise AssertionError("the engine path launched a flash kernel")
    if st["graph_replays"] != st["steps"]:
        raise AssertionError("a step ran outside the graph")
    out["load"] = {"sessions": len(load_prompts), "wall_s": load_s,
                   "tokens": st["tokens"], "steps": st["steps"],
                   "prefill_chunks": st["prefill_chunks"],
                   "prefix_hits": st["prefix"]["applied_hits"]}

    # ---- failover: resume a half-drained stream, bf16
    i = len(SHARED_SUFFIXES) + 2
    prompt, stream = load_prompts[i], load_streams[i]
    cut = len(stream) // 2
    rr = core.handle({"op": "resume", "prompt": prompt,
                      "generated": stream[:cut]})
    resumed = drain(core, rr["sid"], stream[:cut] + list(rr["token"]),
                    len(stream))
    core.handle({"op": "end", "sid": rr["sid"]})
    out["resume_diverged_at"] = same_or_tie(
        f"resume of the {len(prompt)}-token session at token {cut} "
        f"(seq {rr['seq']})", resumed, stream,
        functools.partial(replay_gap, params, cfg, prompt, stream), TIE_BF16)

    # ---- aggregate tokens/s at 8 slots, then TTFT idle and under load
    for streams_n in (ENGINE_SLOTS, ENGINE_SLOTS - 1):
        quiet(core)
        if streams_n == ENGINE_SLOTS - 1:
            out["ttft_idle_ms"] = ttft_ms(core, prompts[2])
            quiet(core)
        streams = Streams(core, prompts[0], streams_n)
        if streams_n == ENGINE_SLOTS:
            out["tokens_per_s_8"], out["ms_per_step_8"] = tokens_per_s(core)
            log(f"  8 streams decoding: {out['tokens_per_s_8']:.1f} tokens/s"
                f" aggregate, {out['ms_per_step_8']:.3f} ms per engine step "
                f"({THROUGHPUT_WINDOW_S:g} s window), with the metrics, "
                f"spans and chaos check on (no claim; PERF.md holds the "
                f"figures from before the hooks) [{card}]")
        else:
            out["ttft_load_ms"] = ttft_ms(core, prompts[2])
            log(f"  TTFT of a {len(prompts[2])}-token prompt: idle "
                f"{out['ttft_idle_ms']:.2f} ms, while 7 streams decode "
                f"{out['ttft_load_ms']:.2f} ms "
                f"({prefill_chunks(len(prompts[2]))} chunk programs) "
                f"[{card}]")
        streams.stop()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    quiet(core)
    st = core.handle({"op": "stats"})["engine"]
    log(f"  peak memory over the bf16 serving runs {out['peak_gib']:.2f} GiB"
        f" (bf16 weights {count_params(cfg) * 2 / 2**30:.2f} GiB); engine "
        f"totals: {st['steps']} steps, {st['graph_replays']} graph "
        f"replays, {st['tokens']} tokens [{card}]")
    if st["graph_replays"] != st["steps"]:
        raise AssertionError("a step ran outside the graph")
    out["hooks"]["bf16 load"] = engine_hooks(card, core, "bf16 load")
    log("  dispatch profile (MFU against 989 TFLOP/s):")
    for row in st["device_profile"]:
        log(f"      {json.dumps(row)}")
    out["device_profile"] = st["device_profile"]
    core.engine.shutdown()
    core.engine._thread.join(timeout=30)
    launches = {k.__name__: k.launches for k in kernels}
    if any(launches.values()):
        raise AssertionError(f"the engine phase launched {launches}")
    del core, params
    torch.cuda.empty_cache()
    return launches, out


def run_steps(card, step, params, batch, kernels, expected, why):
    """TRAIN_STEPS steps of ``step`` on one batch, with the launch counters
    set to 0 just before and read just after: the launches a step must be
    ``expected`` ({kernel: n}; ``why`` says whence) and the loss finite and
    falling.  → (median wall ms of steps 2.., launches, peak GiB)."""
    for kernel in kernels:
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(params, batch)
        losses.append(float(metrics["loss"]))   # syncs
        walls.append((time.perf_counter() - t0) * 1e3)
        log(f"  step {len(losses)}: "
            + " ".join(f"{k} {float(v):.6f}" for k, v in metrics.items())
            + f" wall {walls[-1]:.2f} ms [{card}]")
    launches = {k.__name__: k.launches for k in kernels}
    per_step = {name: n / TRAIN_STEPS for name, n in launches.items()}
    log(f"  launches over {TRAIN_STEPS} steps: {launches} ({per_step} a "
        f"step; expected {why})")
    if per_step != expected:
        raise AssertionError(f"unexpected launches a step: {per_step}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"loss did not fall: {losses}")
    step_ms = float(np.median(walls[1:]))
    log(f"  step time {step_ms:.2f} ms (median of steps 2-{TRAIN_STEPS}; "
        f"first {walls[0]:.2f} ms)")
    return step_ms, launches, torch.cuda.max_memory_allocated() / 2**30


def flash_against_reference(loss_of, cfg, wanted):
    """One step's loss and the gradients of ``wanted`` ({name: parameter})
    with flash attention against the same with reference attention, on the
    same weights: the loss within 1e-2 relative and every gradient's cosine
    >= 0.99.  ``loss_of(cfg)`` → the loss.  → (relative loss error,
    {name: cosine})."""
    results = {}
    for impl in ("flash", "reference"):
        for p in wanted.values():
            p.requires_grad_(True)
        loss = loss_of(dataclasses.replace(cfg, attention_impl=impl))
        results[impl] = (float(loss.detach()),
                         torch.autograd.grad(loss, list(wanted.values())))
        for p in wanted.values():
            p.requires_grad_(False)
    (fl, fg), (rl, rg) = results["flash"], results["reference"]
    rel = abs(fl - rl) / abs(rl)
    cosines = {n: float(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0))
        for n, a, b in zip(wanted, fg, rg)}
    log(f"  flash vs reference attention: loss {fl:.6f} / {rl:.6f} "
        f"(relative {rel:.3e}, must be <= 1e-2); gradient cosines "
        + ", ".join(f"{n} {c:.6f}" for n, c in cosines.items())
        + " (each must be >= 0.99)")
    if not (rel <= 1e-2 and min(cosines.values()) >= 0.99):
        raise AssertionError("flash and reference gradients disagree")
    return rel, cosines


def profile_step(card, what, fn, wall_ms, n=12):
    """Device time by kernel of one call of ``fn`` against its unprofiled
    wall time; → {kernel: ms} (empty where the profiler saw no device)."""
    kernels_ms = device_kernel_ms(fn)
    if not kernels_ms:
        log(f"  {what}: device time not measured (the profiler recorded no "
            f"device activity)")
        return kernels_ms
    busy = sum(kernels_ms.values())
    log(f"  {what}: device busy {busy:.2f} ms of {wall_ms:.2f} ms wall "
        f"({100 * busy / wall_ms:.1f}%), {len(kernels_ms)} kernel names "
        f"[{card}]")
    for name, ms in top_kernels(kernels_ms, n):
        log(f"      {ms:8.3f} ms  {100 * ms / busy:5.1f}%  {name[:110]}")
    return kernels_ms


def phase_train(card, ops):
    from ray_tpu_torch.models import (TransformerConfig, flops_per_token,
                                      init_params, lm_loss, make_train_step,
                                      param_leaves)

    log("== train: llama-1b train step (remat dots, norm_remat, "
        "loss_chunk 128, bf16 weights), 4 x 1024 tokens")
    cfg = TransformerConfig.llama("1b", max_seq_len=TRAIN_SEQ, remat="dots",
                                  norm_remat=True, loss_chunk=128,
                                  param_dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).to("cuda")}
    opt = torch.optim.AdamW(param_leaves(params), lr=3e-4, weight_decay=0.1)
    step = make_train_step(cfg, opt)
    kernels = (ops.flash_fwd, ops.flash_bwd_dq, ops.flash_bwd_dkv)
    step_ms, launches, peak_gib = run_steps(
        card, step, params, batch, kernels,
        {"flash_fwd": 32, "flash_bwd_dq": 16, "flash_bwd_dkv": 16},
        "fwd 32 = 16 + 16 recomputed under remat 'dots', dq 16, dkv 16")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = (flops_per_token(cfg, TRAIN_SEQ) * tokens / (step_ms / 1e3)
           / PEAK_FLOPS[torch.bfloat16])
    log(f"  {tokens / step_ms * 1e3:.0f} tokens/s, MFU {mfu:.4f} of 989 "
        f"TFLOP/s, peak memory {peak_gib:.2f} GiB [{card}]")

    accum = make_train_step(cfg, opt, accum_steps=2)(params, batch)
    accum_loss = float(accum["loss"])
    log(f"  accum_steps=2: loss {accum_loss:.6f} grad_norm "
        f"{float(accum['grad_norm']):.6f}")
    if not np.isfinite(accum_loss):
        raise AssertionError("accum_steps=2 loss is not finite")

    # the full-width check: one step's loss and gradients, flash against
    # reference attention, on the same weights
    wanted = {n: params["layers"][n] for n in ("wq", "wk", "wv", "wo")}
    wanted["lm_head"] = params["lm_head"]
    flash_against_reference(lambda c: lm_loss(params, batch, c), cfg, wanted)
    # where the time goes: device time by kernel for one step
    profile_step(card, "train step", lambda: step(params, batch), step_ms)
    return launches


def moe_layer_breakdown(card, cfg, params):
    """Where one MoE layer's time goes at the train shape (4 x 1024 tokens,
    layer 0's weights, activations N(0, 1) in bf16): routing, the dispatch
    einsum, the experts over their whole capacity, the combine einsum, and
    the layer forward and forward + backward; and the capacity's fill."""
    from ray_tpu_torch.ops import expert_capacity, moe_ffn, route

    b, s, d, f = TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, cfg.ff_dim
    e, k, dt = cfg.n_experts, cfg.expert_top_k, cfg.dtype
    lp = {name: w[0] for name, w in params["layers"].items()}
    y = randn(7, (b, s, d), dt)
    cap = expert_capacity(s, e, k, cfg.capacity_factor)
    dispatch, combine, _ = route(y, lp["router"], k, cap)
    w_in, w_out = lp["w_in"].to(dt), lp["w_out"].to(dt)
    xe = torch.einsum("bsec,bsd->ebcd", dispatch, y)
    oe = torch.einsum("ebcf,efd->ebcd", torch.nn.functional.gelu(
        torch.einsum("ebcd,edf->ebcf", xe, w_in), approximate="tanh"), w_out)
    comb = combine.to(dt)

    def layer():
        return moe_ffn(y, lp["router"], lp["w_in"], lp["w_out"], top_k=k,
                       capacity_factor=cfg.capacity_factor)

    leaves = [y.detach().requires_grad_(True)] + [
        lp[n].detach().requires_grad_(True) for n in ("router", "w_in",
                                                      "w_out")]

    def layer_fwd_bwd():
        out, aux = moe_ffn(*leaves, top_k=k,
                           capacity_factor=cfg.capacity_factor)
        return torch.autograd.grad(out.float().sum() + aux, leaves)

    times = {
        "route": cuda_ms(lambda: route(y, lp["router"], k, cap), iters=10),
        "dispatch": cuda_ms(lambda: torch.einsum("bsec,bsd->ebcd", dispatch,
                                                 y), iters=10),
        "experts": cuda_ms(lambda: torch.einsum(
            "ebcf,efd->ebcd", torch.nn.functional.gelu(torch.einsum(
                "ebcd,edf->ebcf", xe, w_in), approximate="tanh"), w_out),
            iters=10),
        "combine": cuda_ms(lambda: torch.einsum("ebcd,bsec->bsd", oe, comb),
                           iters=10),
        "layer_fwd": cuda_ms(layer, iters=10),
        "layer_fwd_bwd": cuda_ms(layer_fwd_bwd, iters=5),
    }
    held = float(dispatch.float().sum())
    fill = held / (e * b * cap)
    dropped = 1 - held / (b * s * k)
    # products: experts over E·b·C rows, of which b·s·k would be the active
    # tokens' own; dispatch and combine each b·s·E·C·d multiply-adds
    flops = {"experts": 4 * e * b * cap * d * f,
             "active": 4 * b * s * k * d * f,
             "dispatch_combine": 2 * 2 * b * s * e * cap * d}
    log(f"  one MoE layer at {b} x {s} (capacity {cap} a row and expert): "
        + ", ".join(f"{n} {ms:.4f} ms" for n, ms in times.items())
        + f"; {100 * fill:.1f}% of the experts' rows hold a token, "
        f"{100 * dropped:.2f}% of the token choices dropped; expert "
        f"products {flops['experts'] / 1e9:.1f} GFLOP for "
        f"{flops['active'] / 1e9:.1f} active, dispatch + combine "
        f"{flops['dispatch_combine'] / 1e9:.1f} GFLOP [{card}]")
    return {"ms": times, "capacity": cap, "fill": fill, "dropped": dropped,
            "gflop": {n: v / 1e9 for n, v in flops.items()}}


def moe_serve(card, kernels, out):
    """The MoE model served: fp32 streams through the engine, speculating
    and (with no drops) the engine=False core; bf16 graph against eager,
    throughput and TTFT.  → launches by path."""
    from ray_tpu_torch.models import (TransformerConfig, count_params,
                                      init_params)
    from ray_tpu_torch.serve import DecodeEngineConfig, DecodeSessionCore

    ecfg = DecodeEngineConfig(max_slots=ENGINE_SLOTS,
                              prefill_chunk_tokens=ENGINE_CHUNK)
    rng = np.random.default_rng(0)
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    cfg32 = TransformerConfig.gpt2("small", dtype=torch.float32,
                                   **MOE_CONFIG)
    params32 = init_params(cfg32, torch.Generator(device="cuda").manual_seed(
        0), "cuda")
    prompts = [rng.integers(0, cfg32.vocab_size, n).tolist()
               for n in MOE_STREAM_PROMPTS]
    # the capacity factor at which no token drops anywhere (C >= s)
    nodrop = dataclasses.replace(
        cfg32, capacity_factor=cfg32.n_experts / cfg32.expert_top_k)
    log(f"  fp32 streams: prompts of {MOE_STREAM_PROMPTS} tokens, "
        f"{STREAM_TOKENS} tokens each")
    streams, launches = {}, {}
    for what, cfg, engine in (
            ("engine", cfg32, ecfg),
            ("speculating", cfg32, dataclasses.replace(
                ecfg, spec_draft="shared", spec_k=4)),
            ("engine, no drops", nodrop, ecfg),
            ("engine=False, no drops", nodrop, False)):
        core = DecodeSessionCore(cfg, max_len=MOE_MAX_LEN, params=params32,
                                 engine=engine)
        if engine is False:   # the whole-prompt path: the flash kernels
            for kernel in kernels:
                kernel.launches = 0
        t0 = time.perf_counter()
        streams[what] = (eager_streams if engine is False else
                         serve_streams)(core, prompts, STREAM_TOKENS)
        wall = time.perf_counter() - t0
        if engine is False:
            launches["moe_serve"] = {k.__name__: k.launches for k in kernels}
            log(f"  {what}: {wall:.2f} s, kernel launches "
                f"{launches['moe_serve']} (expected flash_fwd "
                f"{cfg.n_layers} a start)")
            if launches["moe_serve"] != {
                    "flash_fwd": cfg.n_layers * len(prompts),
                    "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
                raise AssertionError("unexpected launches on engine=False")
            continue
        quiet(core)
        st = core.handle({"op": "stats"})["engine"]
        core.engine.shutdown()
        core.engine._thread.join(timeout=30)
        log(f"  {what}: {st['steps']} engine iterations, "
            f"{st['graph_replays']} graph replays, spec {st['spec']}, "
            f"{wall:.2f} s")
        if what == "speculating":
            out["fp32_spec_acceptance"] = st["spec"]["acceptance"]
    for i, prompt in enumerate(prompts):
        for what, got, want, cfg, gap in (
                ("speculating against the engine", "speculating", "engine",
                 cfg32, replay_gap),
                ("engine against engine=False, no drops", "engine, no drops",
                 "engine=False, no drops", nodrop, eager_gap)):
            # the gap is the reference path's along the reference stream
            want = streams[want][i]
            same_or_tie(f"prompt {len(prompt)}: {what}", streams[got][i],
                        want, functools.partial(gap, params32, cfg, prompt,
                                                want, max_len=MOE_MAX_LEN),
                        TIE_FP32)
    del core, params32
    gc.collect()            # the engines' threads hold them in cycles
    torch.cuda.empty_cache()

    # ---- bf16: graph against eager, bitwise; throughput and TTFT
    cfg = TransformerConfig.gpt2("small", param_dtype=torch.bfloat16,
                                 **MOE_CONFIG)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    state = GraphState(cfg, params, MOE_MAX_LEN,
                       [5, 100, 300, 517, 700, 900, MOE_MAX_LEN - 2,
                        MOE_MAX_LEN - 1])
    same_toks, same_pos, graph_pos, diff, _ = state.compare()
    state.restore()
    state.step.load(state.tokens, state.active)
    out["graph_ms"] = cuda_ms(state.step.graph.replay, iters=100)
    out["eager_ms"] = cuda_ms(state.step._step, iters=10)
    log(f"  graph against eager from one state (8 slots active, pos "
        f"{state.saved['pos'].tolist()}): tokens equal {same_toks}, pos "
        f"equal {same_pos} ({graph_pos}), logits max|diff| {diff:.3e} (must "
        f"be 0); decode step, 8 slots: graph {out['graph_ms']:.4f} ms, eager "
        f"{out['eager_ms']:.4f} ms device [{card}]")
    if not (same_toks and same_pos and diff == 0.0):
        raise AssertionError("the graph replay and the eager step disagree")
    profile_step(card, "MoE graph replay, 8 slots",
                 lambda: state.step.run(state.tokens, state.active),
                 out["graph_ms"], n=8)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    for kernel in kernels:
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2**30
    core = DecodeSessionCore(cfg, max_len=MOE_MAX_LEN, params=params,
                             engine=ecfg)
    ttft_prompt = rng.integers(0, cfg.vocab_size, MOE_TTFT_PROMPT).tolist()
    ttft_ms(core, ttft_prompt[:17])     # the first use of each program
    quiet(core)
    out["ttft_idle_ms"] = ttft_ms(core, ttft_prompt)
    quiet(core)
    streams = Streams(core, ttft_prompt[:17], ENGINE_SLOTS)
    out["tokens_per_s_8"], out["ms_per_step_8"] = tokens_per_s(core)
    streams.stop()
    quiet(core)
    st = core.handle({"op": "stats"})["engine"]
    core.engine.shutdown()
    core.engine._thread.join(timeout=30)
    launches["moe_engine"] = {k.__name__: k.launches for k in kernels}
    out["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"  bf16 engine: TTFT of a {MOE_TTFT_PROMPT}-token prompt, idle, "
        f"{out['ttft_idle_ms']:.2f} ms ({prefill_chunks(MOE_TTFT_PROMPT)} "
        f"chunk programs); 8 streams decoding: {out['tokens_per_s_8']:.1f} "
        f"tokens/s, {out['ms_per_step_8']:.3f} ms per engine step; "
        f"{st['steps']} steps, {st['graph_replays']} graph replays; kernel "
        f"launches {launches['moe_engine']}; peak memory "
        f"{out['serve_peak_gib']:.2f} GiB, {held_gib:.2f} GiB of it held "
        f"before the engine started (the bf16 weights "
        f"{count_params(cfg) * 2 / 2**30:.2f} GiB) [{card}]")
    if any(launches["moe_engine"].values()):
        raise AssertionError("the engine path launched a flash kernel")
    if st["graph_replays"] != st["steps"]:
        raise AssertionError("a step ran outside the graph")
    del core, params
    torch.cuda.empty_cache()
    return launches


def phase_moe(card, ops):
    from ray_tpu_torch.models import (TransformerConfig, count_params,
                                      flops_per_token, forward_with_aux,
                                      init_params, lm_loss, make_train_step,
                                      param_leaves)

    log("== moe: gpt2-small with 8 experts, top 2 (capacity factor 2.0, "
        "router aux weight 0.01), fp32 weights, bf16 compute")
    kernels = (ops.flash_fwd, ops.flash_bwd_dq, ops.flash_bwd_dkv)
    cfg = TransformerConfig.gpt2("small", remat=False, norm_remat=True,
                                 loss_chunk=128, **MOE_CONFIG)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).to("cuda")}
    # torch.optim.AdamW keeps its moments in the parameters' dtype, fp32
    opt = torch.optim.AdamW(param_leaves(params), lr=3e-4, weight_decay=0.1)
    step = make_train_step(cfg, opt)
    step_ms, train_launches, peak_gib = run_steps(
        card, step, params, batch, kernels,
        {name: cfg.n_layers for name in ("flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkv")},
        f"{cfg.n_layers} of each: one a layer, remat off")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = flops_per_token(cfg, TRAIN_SEQ)
    out = {"step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
           "mfu": flops * tokens / (step_ms / 1e3) / PEAK_FLOPS[
               torch.bfloat16], "train_peak_gib": peak_gib,
           "params": count_params(cfg)}
    log(f"  {count_params(cfg) / 1e6:.1f} M parameters; "
        f"{out['tokens_per_s']:.0f} tokens/s, MFU {out['mfu']:.4f} of 989 "
        f"TFLOP/s (active "
        f"FLOPs: {flops / 1e9:.3f} GFLOP a token), peak memory "
        f"{peak_gib:.2f} GiB (fp32 weights, gradients and AdamW moments: "
        f"torch.optim.AdamW has no bf16 first moment) "
        f"[{card}]")
    with torch.no_grad():
        out["aux"] = float(forward_with_aux(params, batch["tokens"], cfg)[1])
    log(f"  router aux loss (mean over layers) {out['aux']:.6f}")
    if not (np.isfinite(out["aux"]) and out["aux"] > 0):
        raise AssertionError("the router aux loss is not finite and > 0")
    wanted = {n: params["layers"][n] for n in ("router", "w_in", "w_out",
                                                "wq")}
    out["loss_rel"], out["cosines"] = flash_against_reference(
        lambda c: lm_loss(params, batch, c), cfg, wanted)
    profile_step(card, "MoE train step", lambda: step(params, batch),
                 step_ms)
    out["layer"] = moe_layer_breakdown(card, cfg, params)
    # nothing of the training run may stay alive into the serving runs'
    # peak memory
    del params, opt, step, wanted, batch
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"moe_train": train_launches}
    launches.update(moe_serve(card, kernels, out))
    return launches, out


def phase_vit(card, ops):
    from ray_tpu_torch.models import (ViTConfig, flops_per_token,
                                      init_vit_params, make_vit_train_step,
                                      param_leaves, vit_forward, vit_loss)

    log("== vit: ViT-B/16 at 224 x 224, fp32 weights, bf16 compute")
    kernels = (ops.flash_fwd, ops.flash_bwd_dq, ops.flash_bwd_dkv)
    cfg = ViTConfig.base()
    params = init_vit_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (cfg.image_size, cfg.image_size, cfg.channels)
    batch = {"image": torch.randn((VIT_TRAIN_BATCH, *shape), generator=gen,
                                  device="cuda"),
             "label": torch.randint(0, cfg.num_classes, (VIT_TRAIN_BATCH,),
                                    generator=gen, device="cuda")}
    opt = torch.optim.AdamW(param_leaves(params), lr=3e-4, weight_decay=0.1)
    step = make_vit_train_step(cfg, opt)
    step_ms, train_launches, peak_gib = run_steps(
        card, step, params, batch, kernels,
        {name: cfg.n_layers for name in ("flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkv")},
        f"{cfg.n_layers} of each: one a layer, remat off")
    # FLOPs an image as the JAX package's probe counts them
    # (tpu_probe20.py:39-40): the encoder's training FLOPs a token x tokens
    flops = flops_per_token(cfg.block_cfg(), cfg.seq_len) * cfg.seq_len
    out = {"step_ms": step_ms,
           "images_per_s": VIT_TRAIN_BATCH / step_ms * 1e3,
           "mfu": flops * VIT_TRAIN_BATCH / (step_ms / 1e3) / PEAK_FLOPS[
               torch.bfloat16], "peak_gib": peak_gib}
    log(f"  train, batch {VIT_TRAIN_BATCH}: {out['images_per_s']:.1f} "
        f"images/s, MFU {out['mfu']:.4f} of 989 TFLOP/s ({flops / 1e9:.1f} "
        f"GFLOP an image), peak memory {peak_gib:.2f} GiB [{card}]")
    wanted = {"patch.w": params["patch"]["w"], "wq": params["layers"]["wq"],
              "w_in": params["layers"]["w_in"], "head.w": params["head"]["w"]}
    out["loss_rel"], out["cosines"] = flash_against_reference(
        lambda c: vit_loss(params, batch, c)[0], cfg, wanted)
    profile_step(card, "ViT train step", lambda: step(params, batch), step_ms,
                 n=8)
    del opt, step, batch

    # batch-predict: the forward alone at 256 images
    images = torch.randn((VIT_PREDICT_BATCH, *shape), generator=gen,
                         device="cuda")
    with torch.no_grad():
        for kernel in kernels:
            kernel.launches = 0
        logits = vit_forward(params, images, cfg)
        torch.cuda.synchronize()
        predict_launches = {k.__name__: k.launches for k in kernels}
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vit_forward(params, images, cfg)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        ref = vit_forward(params, images, dataclasses.replace(
            cfg, attention_impl="reference"))
    cos = torch.nn.functional.cosine_similarity(logits, ref, dim=-1)
    predict_ms = float(np.median(walls))
    out["predict_ms"] = predict_ms
    out["predict_images_per_s"] = VIT_PREDICT_BATCH / predict_ms * 1e3
    out["predict_cosine_min"] = float(cos.min())
    log(f"  batch-predict, batch {VIT_PREDICT_BATCH}: {predict_ms:.2f} ms "
        f"(median of 5), {out['predict_images_per_s']:.1f} images/s; kernel "
        f"launches {predict_launches} (expected flash_fwd {cfg.n_layers}); "
        f"logits against reference attention: cosine per image min "
        f"{out['predict_cosine_min']:.6f} (must be >= 0.99), max|diff| "
        f"{float((logits - ref).abs().max()):.3e} [{card}]")
    if predict_launches != {"flash_fwd": cfg.n_layers, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}:
        raise AssertionError("unexpected launches in batch-predict")
    if not (torch.isfinite(logits).all() and tuple(logits.shape) == (
            VIT_PREDICT_BATCH, cfg.num_classes) and cos.min() >= 0.99):
        raise AssertionError("ViT logits disagree with reference attention")
    del params, images, logits, ref
    torch.cuda.empty_cache()
    return {"vit_train": train_launches, "vit_predict": predict_launches}, out


class fp32_ieee:
    """Full fp32 products and convolutions on the card (no TF32) inside the
    block, the flags as they were after it."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.fp32_precision,
                      torch.backends.cudnn.conv.fp32_precision)
        torch.backends.cuda.matmul.fp32_precision = "ieee"
        torch.backends.cudnn.conv.fp32_precision = "ieee"

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.fp32_precision,
         torch.backends.cudnn.conv.fp32_precision) = self.saved


def rl_diverged(policy, params, traj, draws, got_action):
    """Per env, the first step whose action differs from ``got_action``
    (T where none does), and the largest top-two gap of ``pi + noise`` at
    such a step: the reference's own margin there, a near-tie only when it
    is under RL_TIE."""
    steps, n = got_action.shape
    differs = got_action != traj["action"]
    first = torch.where(differs.any(0), differs.int().argmax(0),
                        torch.full((n,), steps))
    gap = 0.0
    for env in torch.nonzero(first < steps).flatten().tolist():
        t = int(first[env])
        pi, _ = policy.forward(params, traj["obs"][t, env:env + 1])
        top = (pi[0] + draws[t]["noise"][env]).topk(2).values
        gap = max(gap, float(top[0] - top[1]))
    return first, gap


def rl_card_equals_cpu(card):
    """A PixelPong conv-PPO rollout (RL_PARITY_ENVS x RL_PARITY_STEPS) on
    the card and on the CPU from the same weights and draws, then one
    update of the CPU rollout's batch on each with the same permutations,
    in full fp32.  Envs are independent: an env whose sampled action
    differs at some step (a near-tie of pi + noise, top two under RL_TIE)
    is compared up to that step, and any other difference fails."""
    from ray_tpu_torch.rl import (ClippedAdam, PixelPong, PPOConfig,
                                  build_policy, compute_gae, make_rollout_fn,
                                  make_update_fn)
    from ray_tpu_torch.rl.policy import tree_leaves, tree_map

    class FirstGrads(ClippedAdam):
        """The optimizer, keeping the gradients of its first step."""
        first = None

        def update(self, grads, state, params):
            if self.first is None:
                self.first = [g.detach().clone() for g in grads]
            super().update(grads, state, params)

    n, steps = RL_PARITY_ENVS, RL_PARITY_STEPS
    cfg = PPOConfig(**dict(RL_PONG, num_envs=n, rollout_length=steps))
    gen = torch.Generator().manual_seed(1)
    sides = {}
    for device in ("cpu", "cuda"):
        env = PixelPong(device=device)
        sides[device] = (env, build_policy(env, {"hidden": cfg.hidden},
                                           device=device))
    env, policy = sides["cpu"]
    params = policy.init(gen)
    first = env.reset_draws(n, gen)
    draws = [{"noise": policy.draw_noise(n, gen),
              "reset": env.reset_draws(n, gen)} for _ in range(steps)]
    perms = torch.stack([torch.randperm(n * steps, generator=gen)
                         for _ in range(cfg.num_sgd_epochs)])
    rollouts, updates, flat = {}, {}, None
    with fp32_ieee():
        for device, (env, policy) in sides.items():
            def to(tree):
                return tree_map(lambda x: x.to(device), tree)

            p = policy.set_weights(params, policy.get_weights(params))
            state, obs = env.reset_given(to(first))
            traj, _, _, _, last_value = make_rollout_fn(
                env, policy, n, steps, env_chunk=cfg.env_chunk)(
                    p, state, obs, (), None, to(draws))
            on_card(f"rl card = CPU, the rollout on {device}")
            rollouts[device] = tree_map(lambda x: x.cpu(), (traj,
                                                            last_value))
            if flat is None:          # the CPU's batch, for both updates
                adv, ret = compute_gae(traj, last_value, cfg.gamma,
                                       cfg.gae_lambda)
                flat = {"obs": traj["obs"].reshape(n * steps, -1),
                        "action": traj["action"].reshape(-1),
                        "logp": traj["logp"].reshape(-1),
                        "adv": adv.reshape(-1), "ret": ret.reshape(-1)}
            opt = FirstGrads(cfg.max_grad_norm, cfg.lr)
            opt_state = opt.init(p)
            _, _, metrics = make_update_fn(policy, opt, cfg, n * steps)(
                p, opt_state, to(flat), None, perms.to(device))
            on_card(f"rl card = CPU, the update on {device}")
            updates[device] = tree_map(lambda x: x.detach().cpu(), {
                "params": p, "mu": opt_state["mu"], "nu": opt_state["nu"],
                "metrics": metrics, "grads": opt.first})
    (cpu, cpu_last), (gpu, gpu_last) = rollouts["cpu"], rollouts["cuda"]
    diverged, gap = rl_diverged(sides["cpu"][1], params, cpu, draws,
                                gpu["action"])
    n_div = int((diverged < steps).sum())
    if gap > RL_TIE:
        raise AssertionError(f"rl: a card action differs from the CPU's "
                             f"where the top two were {gap:.3e} apart")
    t = torch.arange(steps)[:, None]
    seen, acted = t <= diverged, t < diverged     # [T, N] compared entries
    errs = {}
    for key, mask in (("obs", seen), ("action", acted), ("reward", acted),
                      ("done", acted), ("logp", seen), ("value", seen)):
        got, want = gpu[key][mask], cpu[key][mask]
        exact = key in ("obs", "action", "reward", "done")
        if exact and not torch.equal(got, want):
            raise AssertionError(f"rl: the card's rollout {key} differs "
                                 f"from the CPU's")
        if not exact:
            errs[key] = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=RL_TOL[0],
                                  atol=RL_TOL[1]):
                raise AssertionError(f"rl: the card's {key} differs from "
                                     f"the CPU's by {errs[key]:.3e}")
    whole = diverged == steps
    errs["last_value"] = float((gpu_last - cpu_last)[whole].abs().max())
    if not torch.allclose(gpu_last[whole], cpu_last[whole], rtol=RL_TOL[0],
                          atol=RL_TOL[1]):
        raise AssertionError("rl: the card's last value differs")
    gu, cu = updates["cuda"], updates["cpu"]
    for what, bound in (("grads", RL_GRAD_TOL), ("mu", RL_MOMENT_TOL),
                        ("nu", RL_MOMENT_TOL)):
        errs[what] = max(float((g - c).norm() / c.norm().clamp_min(1e-30))
                         for g, c in zip(tree_leaves(gu[what]),
                                         tree_leaves(cu[what])))
        if errs[what] > bound:
            raise AssertionError(f"rl: the card's update {what} differs from "
                                 f"the CPU's by {errs[what]:.3e} of a norm")
    pairs = list(zip(tree_leaves(gu["metrics"]), tree_leaves(cu["metrics"])))
    errs["metrics"] = max(float((g - c).abs().max()) for g, c in pairs)
    if not all(torch.allclose(g, c, rtol=RL_LOSS_TOL[0],
                              atol=RL_LOSS_TOL[1]) for g, c in pairs):
        raise AssertionError(f"rl: the card's loss parts differ from the "
                             f"CPU's by {errs['metrics']:.3e}")
    errs["params_in_steps"] = max(float((g - c).abs().max()) / cfg.lr
                                  for g, c in zip(tree_leaves(gu["params"]),
                                                  tree_leaves(cu["params"])))
    if errs["params_in_steps"] > RL_PARAM_STEPS:
        raise AssertionError(f"rl: a card param differs from the CPU's by "
                             f"{errs['params_in_steps']:.3f} Adam steps")
    log(f"  card = CPU: PixelPong conv-PPO, {n} envs x {steps} steps, fp32 "
        f"(no TF32): observations, actions, rewards, dones equal "
        f"({n_div} envs compared up to a near-tie action, top two "
        f"{gap:.2e} apart); max |diff| logp {errs['logp']:.3e}, value "
        f"{errs['value']:.3e}; one update ({cfg.num_sgd_epochs} epochs x "
        f"{cfg.num_minibatches} minibatches) of the same batch: first "
        f"gradients {errs['grads']:.2e} of a norm, Adam mu {errs['mu']:.2e}, "
        f"nu {errs['nu']:.2e}, loss parts {errs['metrics']:.3e}, params "
        f"{errs['params_in_steps']:.3f} of an Adam step (lr) [{card}]")
    return {"envs": n, "steps": steps, "near_tie_envs": n_div,
            "max_abs_err": errs}


def rl_run(card, what, env_cls, config):
    """One warm iteration, RL_TIMED_ITERS timed ones (synced by the
    iteration's read of its metrics), one split into the rollout with GAE
    and the update (each synced), one profiled; → its readings."""
    from ray_tpu_torch.rl import PPOConfig

    torch.cuda.reset_peak_memory_stats()
    cfg = PPOConfig(env=env_cls, **config)
    t0 = time.perf_counter()
    algo = cfg.build()
    res = algo.train()
    warm_s = time.perf_counter() - t0
    walls = []
    for _ in range(RL_TIMED_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = algo.train()
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    collected = algo.collect()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    metrics = algo.learn(collected)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    loss = {k: float(v) for k, v in metrics.items()}
    wall = float(np.median(walls))
    steps = cfg.num_envs * cfg.rollout_length
    kernels_ms = profile_step(card, f"{what}: one profiled iteration",
                              algo.train, wall, n=6)
    ops_n, kernels_n = host_ops(algo.collect)
    out = {"env_steps_per_s": steps / wall * 1e3, "iteration_ms": walls,
           "warm_s": warm_s, "rollout_ms": (t1 - t0) * 1e3,
           "update_ms": (t2 - t1) * 1e3, "loss": loss,
           "episode_reward_mean": res["episode_reward_mean"],
           "device_busy_ms": sum(kernels_ms.values()) if kernels_ms
           else None,
           "ops_per_rollout_step": ops_n / cfg.rollout_length,
           "kernels_per_rollout_step": kernels_n / cfg.rollout_length,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    out["device_busy_share"] = (out["device_busy_ms"] / wall
                                if kernels_ms else None)
    log(f"  {what}: {cfg.num_envs} envs x {cfg.rollout_length} steps, "
        f"{out['env_steps_per_s']:.0f} env-steps/s (iterations "
        f"{', '.join(f'{w:.1f}' for w in walls)} ms; the first, warm, "
        f"{warm_s:.2f} s with the build); rollout + GAE "
        f"{out['rollout_ms']:.1f} ms, update {out['update_ms']:.1f} ms "
        f"(synced); {ops_n / cfg.rollout_length:.0f} ops and "
        f"{kernels_n / cfg.rollout_length:.0f} kernels a rollout step; loss "
        f"{loss}; episode_reward_mean {res['episode_reward_mean']:.3f}; peak "
        f"{out['peak_gib']:.2f} GiB [{card}]")
    if not all(np.isfinite(v) for v in loss.values()) or not np.isfinite(
            res["episode_reward_mean"]):
        raise AssertionError(f"{what}: a loss or the episode reward is not "
                             f"finite")
    del algo, collected
    gc.collect()
    return out


def phase_rl(card, ops):
    from ray_tpu_torch.rl import CartPole, PixelPong

    log("== rl: PPO on the card (PixelPong conv-PPO at 4096 x 64, CartPole "
        "MLP-PPO at 128 x 128), and a PixelPong rollout and update against "
        "the CPU")
    kernels = (ops.flash_fwd, ops.flash_bwd_dq, ops.flash_bwd_dkv)
    out = {"card_equals_cpu": rl_card_equals_cpu(card)}
    for kernel in kernels:
        kernel.launches = 0
    out["pixelpong"] = rl_run(card, "PixelPong conv-PPO", PixelPong,
                              RL_PONG)
    out["cartpole"] = rl_run(card, "CartPole MLP-PPO", CartPole,
                             RL_CARTPOLE)
    launches = {k.__name__: k.launches for k in kernels}
    if any(launches.values()):
        raise AssertionError(f"the rl path launched {launches}")
    return launches, out


# -- offpolicy: the replay-buffer family of RL ----------------------------------

def off_copy(src, dst):
    """``src``'s params, targets, Adam state, buffer, envs and env-step
    count onto ``dst``, a twin on another device (copies)."""
    from ray_tpu_torch.rl.policy import tree_map

    def to(tree):
        return tree_map(lambda x: x.to(dst.device, copy=True), tree)

    dst.params, dst.target_params = to(src.params), to(src.target_params)
    dst.opt_state = {"count": src.opt_state["count"],
                     "mu": to(src.opt_state["mu"]),
                     "nu": to(src.opt_state["nu"])}
    dst.buffer = {k: (to(v) if torch.is_tensor(v) or isinstance(v, dict)
                      else v) for k, v in src.buffer.items()}
    dst.env_states, dst.obs = to(src.env_states), to(src.obs)
    dst._total_env_steps = src._total_env_steps


def off_written(algo, cursor, steps):
    """The buffer rows a collect of ``steps`` steps wrote from ``cursor``,
    as [T, N, ...] views, on the CPU."""
    n, cap = algo.config.num_envs, algo.config.buffer_capacity
    idx = (cursor + torch.arange(steps * n, device=algo.device)) % cap
    return {k: v[idx].cpu().reshape((steps, n) + v.shape[1:])
            for k, v in algo.buffer["data"].items()}


def off_sample_margin(algo, u, idx):
    """Per sample, how close ``u`` fell to an edge of its slot's share of
    the cumulative priorities (relative to the total), on the CPU side:
    the sampler's near-tie."""
    n = max(algo.buffer["size"], 1)
    w = (algo.buffer["priority"][:n].double() + 1e-6) ** algo.config.per_alpha
    cdf = torch.cumsum(w, 0)
    v = u.double() * cdf[-1]
    hi = cdf[idx]
    lo = torch.where(idx > 0, cdf[(idx - 1).clamp_min(0)], 0.0)
    return torch.minimum(v - lo, hi - v) / cdf[-1]


def off_priority_err(cpu, gpu):
    """The largest relative difference of the filled slots' priorities
    and of the running max, card against CPU."""
    size = cpu.buffer["size"]
    pairs = [(gpu.buffer["priority"][:size], cpu.buffer["priority"][:size]),
             (gpu.buffer["max_priority"], cpu.buffer["max_priority"])]
    return max(float(((g.cpu() - c).abs() / c).max()) for g, c in pairs)


def rainbow_card_equals_cpu(card):
    """One Rainbow iteration (double-Q, dueling, 3-step, PER, 51 atoms; 16
    envs x 8 steps, buffer 512, batch 32, 4 updates, learn_start 64) on
    the card and on the CPU from the same weights, buffer and draws, full
    fp32.  The collect: rows, cursor and size as OFF_PARITY_TOL says, an
    action differing only at a Q near-tie (then that env is compared up
    to there).  The updates then start from the CPU's buffer on both
    sides: the first update's sampled indices exactly, its C51
    projection, TD loss and gradients within OFF_FIRST_TOL of a norm, the
    priorities it writes within OFF_FIRST_TOL relative; each later
    update's indices equal to the card's own sampler's but at a sampler
    near-tie, and the state after the 4 updates within the measured
    OFF_LATER_* bounds."""
    from ray_tpu_torch.rl import CartPole, RainbowConfig
    from ray_tpu_torch.rl.dqn import categorical_projection
    from ray_tpu_torch.rl.exploration import anneal
    from ray_tpu_torch.rl.learner import value_and_grad
    from ray_tpu_torch.rl.policy import tree_leaves, tree_map

    sides = {dev: RainbowConfig(env=CartPole, device=dev, **OFF_PARITY)
             .build() for dev in ("cpu", "cuda")}
    cpu, gpu = sides["cpu"], sides["cuda"]
    cfg = cpu.config
    n, steps, b = cfg.num_envs, cfg.rollout_steps, cfg.batch_size
    cpu.collect()                           # pre-filled past learn_start
    off_copy(cpu, gpu)
    gen = torch.Generator().manual_seed(2)
    draws = [{"uniform": torch.rand(n, generator=gen),
              "random": torch.randint(2, (n,), generator=gen),
              "reset": cpu.env.reset_draws(n, gen)} for _ in range(steps)]
    us = [torch.rand(b, generator=gen) for _ in range(cfg.num_updates)]
    cursor = cpu.buffer["cursor"]
    errs = {}
    cpu.collect(draws)
    gpu.collect(tree_map(lambda x: x.cuda(), draws))
    on_card("offpolicy card = CPU, the collect")
    for what in ("cursor", "size"):
        if gpu.buffer[what] != cpu.buffer[what]:
            raise AssertionError(f"offpolicy: the card's buffer {what} "
                                 f"differs from the CPU's")
    crow, grow = (off_written(a, cursor, steps) for a in (cpu, gpu))
    differs = grow["action"] != crow["action"]
    first = torch.where(differs.any(0), differs.int().argmax(0),
                        torch.full((n,), steps))
    gap = 0.0
    for env in torch.nonzero(first < steps).flatten().tolist():
        t = int(first[env])
        top = cpu.q.apply(cpu.params, crow["obs"][t, env:env + 1])[0].topk(2)
        gap = max(gap, float(top.values[0] - top.values[1]))
    if gap > OFF_TIE:
        raise AssertionError(f"offpolicy: a card action differs from the "
                             f"CPU's where the Q top two were {gap:.3e} "
                             f"apart")
    t = torch.arange(steps)[:, None]
    seen, acted = t <= first, t < first
    for key, mask in (("obs", seen), ("action", acted), ("reward", acted),
                      ("done", acted), ("next_obs", acted)):
        got, want = grow[key][mask], crow[key][mask]
        errs[key] = float((got - want).abs().max()) if got.numel() else 0.0
        if not (torch.equal(got, want) if key in ("action", "reward", "done")
                else torch.allclose(got, want, rtol=OFF_PARITY_TOL[0],
                                    atol=OFF_PARITY_TOL[1])):
            raise AssertionError(f"offpolicy: the card's collected {key} "
                                 f"differs from the CPU's by "
                                 f"{errs[key]:.3e}")
    obs_exact = all(torch.equal(grow[k][m], crow[k][m]) for k, m in
                    (("obs", seen), ("next_obs", acted)))
    # the updates, from the CPU's buffer on both sides, one at a time
    off_copy(cpu, gpu)
    for algo in (cpu, gpu):
        algo.config = dataclasses.replace(cfg, num_updates=1)
    beta = anneal(cpu._total_env_steps, cfg.per_beta, cfg.per_beta_final,
                  cfg.eps_decay_steps)
    sample = cpu._replay_ops[2]
    losses, margin, n_tie = {"cpu": [], "cuda": []}, 1.0, 0
    for k, u in enumerate(us):
        _, ci, _ = sample(cpu.buffer, b, draw={"u": u})
        _, gi, _ = sample(gpu.buffer, b, draw={"u": u.cuda()})
        gi = gi.cpu()
        if k == 0 and not torch.equal(gi, ci):
            raise AssertionError("offpolicy: the card sampled other slots "
                                 "than the CPU in the first update")
        if not torch.equal(gi, ci):
            off = gi != ci
            m = float(off_sample_margin(cpu, u, ci)[off].max())
            n_tie += int(off.sum())
            if m > OFF_SAMPLE_TIE:
                raise AssertionError(f"offpolicy: the card's sampler chose "
                                     f"another slot {m:.3e} of the total "
                                     f"away from an edge")
        if k == 0:
            parts = {}
            for dev, algo in sides.items():
                batch, idx, w = algo._replay_ops[2](
                    algo.buffer, b, draw={"idx": ci.to(dev)}, beta_now=beta)
                batch = algo._targets_batch(batch, idx)
                proj = categorical_projection(algo.q, algo.params,
                                              algo.target_params, batch,
                                              cfg.double_q)
                loss, ce, grads = value_and_grad(
                    algo._td_loss, algo.params, algo.target_params, batch, w)
                parts[dev] = tree_map(lambda x: x.cpu(), {
                    "proj": proj, "loss": loss, "grads": grads})
            on_card("offpolicy card = CPU, the first update's parts")
            g, c = parts["cuda"], parts["cpu"]
            errs["first"] = {
                "proj": float((g["proj"] - c["proj"]).norm()
                              / c["proj"].norm()),
                "loss": float((g["loss"] - c["loss"]).abs()
                              / c["loss"].abs()),
                "grads": max(float((x - y).norm() / y.norm().clamp_min(
                    1e-30)) for x, y in zip(g["grads"], c["grads"]))}
        for dev, algo in sides.items():
            out = algo.learn([{"idx": ci.to(dev)}])
            losses[dev].append(out["td_loss"].cpu())
        on_card(f"offpolicy card = CPU, update {k}")
        if k == 0:
            errs["first"]["priorities"] = off_priority_err(cpu, gpu)
            if not max(errs["first"].values()) <= OFF_FIRST_TOL:
                raise AssertionError(f"offpolicy: the card's first update "
                                     f"differs from the CPU's: "
                                     f"{errs['first']}")
    later = {
        "loss": max(float((g - c).abs() / c.abs())
                    for g, c in zip(losses["cuda"], losses["cpu"])),
        "priorities": off_priority_err(cpu, gpu),
        "params_in_steps": max(
            float((g.cpu() - c).abs().max()) / cfg.lr
            for g, c in zip(tree_leaves(gpu.params),
                            tree_leaves(cpu.params))),
        "moments": max(float((g.cpu() - c).norm() / c.norm().clamp_min(
            1e-30)) for what in ("mu", "nu") for g, c in zip(
                tree_leaves(gpu.opt_state[what]),
                tree_leaves(cpu.opt_state[what])))}
    errs["later"] = later
    for key, bound in OFF_LATER_TOL.items():
        if not later[key] <= bound:
            raise AssertionError(f"offpolicy: after {cfg.num_updates} "
                                 f"updates the card's {key} differ from the "
                                 f"CPU's by {later[key]:.3e} (bound "
                                 f"{bound:.1e})")
    n_div = int((first < steps).sum())
    log(f"  card = CPU: Rainbow (double-Q, dueling, 3-step, PER, 51 atoms), "
        f"{n} envs x {steps} steps, buffer {cfg.buffer_capacity}, batch {b}, "
        f"fp32 (no TF32): actions, rewards, dones, cursor and size equal "
        f"({n_div} envs compared up to a Q near-tie, top two {gap:.2e} "
        f"apart); observations {'bitwise equal' if obs_exact else 'within'}"
        f" (max |diff| {max(errs['obs'], errs['next_obs']):.3e}); first "
        f"update: indices equal, projection {errs['first']['proj']:.2e}, "
        f"loss {errs['first']['loss']:.2e}, gradients "
        f"{errs['first']['grads']:.2e} of a norm, priorities "
        f"{errs['first']['priorities']:.2e} relative; after "
        f"{cfg.num_updates} updates ({n_tie} samples parted at a sampler "
        f"near-tie): losses {later['loss']:.2e}, priorities "
        f"{later['priorities']:.2e} relative, params "
        f"{later['params_in_steps']:.4f} of an Adam step (lr), moments "
        f"{later['moments']:.2e} of a norm [{card}]")
    return {"envs": n, "steps": steps, "near_tie_envs": n_div,
            "sampler_ties": n_tie, "observations_bitwise": obs_exact,
            "max_err": errs}


def off_run(card, what, cfg, learn_start):
    """Warm iterations until the buffer holds ``learn_start`` rows (PG:
    one), OFF_TIMED_ITERS timed ones, one split into the collect and the
    updates (each synced), one profiled; → its readings."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    algo = cfg.build()
    warm = 0
    buffer = getattr(algo, "buffer", None)
    while True:
        res = algo.train()
        warm += 1
        if buffer is None or buffer["size"] >= learn_start:
            break
    warm_s = time.perf_counter() - t0
    if buffer is not None and buffer["size"] < learn_start:
        raise AssertionError(f"{what}: the buffer holds {buffer['size']} "
                             f"rows, under learn_start {learn_start}")
    walls = []
    for _ in range(OFF_TIMED_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = algo.train()
        walls.append((time.perf_counter() - t0) * 1e3)
    key = next(k for k in ("td_loss", "td_abs", "critic_loss", "pg_loss")
               if k in res)
    if not (np.isfinite(res[key]) and res[key] != 0):
        raise AssertionError(f"{what}: {key} {res[key]} is not a finite, "
                             f"nonzero loss: the updates did not run")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    collected = algo.collect()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if buffer is None:
        algo.learn(collected)
    else:
        algo.learn()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    wall = float(np.median(walls))
    steps = res["env_steps_this_iter"]
    kernels_ms = profile_step(card, f"{what}: one profiled iteration",
                              algo.train, wall, n=6)
    t_len = getattr(cfg, "rollout_steps", None) or getattr(
        cfg, "seq_len", None) or cfg.rollout_length
    ops_c, kernels_c = host_ops(algo.collect)
    if buffer is None:
        batch = algo.collect()
        ops_u, kernels_u = host_ops(lambda: algo.learn(batch))
        n_upd = 1
    else:
        ops_u, kernels_u = host_ops(algo.learn)
        n_upd = cfg.num_updates
    out = {"env_steps_per_s": steps / wall * 1e3, "iteration_ms": walls,
           "warm_iterations": warm, "warm_s": warm_s,
           "collect_ms": (t1 - t0) * 1e3, "updates_ms": (t2 - t1) * 1e3,
           key: res[key],
           # None where no episode ended yet (Pendulum runs 200 steps)
           "episode_reward_mean": (res["episode_reward_mean"] if np.isfinite(
               res["episode_reward_mean"]) else None),
           "device_busy_ms": sum(kernels_ms.values()) if kernels_ms
           else None,
           "ops_per_collect_step": ops_c / t_len,
           "kernels_per_collect_step": kernels_c / t_len,
           "ops_per_update": ops_u / n_upd,
           "kernels_per_update": kernels_u / n_upd,
           "largest_kernels_ms": dict(top_kernels(kernels_ms, 4)),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    out["device_busy_share"] = (out["device_busy_ms"] / wall
                                if kernels_ms else None)
    log(f"  {what}: {out['env_steps_per_s']:.0f} env-steps/s (iterations "
        f"{', '.join(f'{w:.1f}' for w in walls)} ms after {warm} warm, "
        f"{warm_s:.2f} s); collect {out['collect_ms']:.1f} ms, updates "
        f"{out['updates_ms']:.1f} ms (synced); "
        f"{out['ops_per_collect_step']:.0f} ops / "
        f"{out['kernels_per_collect_step']:.0f} kernels a collect step, "
        f"{out['ops_per_update']:.0f} / {out['kernels_per_update']:.0f} an "
        f"update; {key} {res[key]:.4g}; episode_reward_mean "
        f"{res['episode_reward_mean']:.3f}; peak {out['peak_gib']:.3f} GiB "
        f"[{card}]")
    del algo, collected
    gc.collect()
    return out


def phase_offpolicy(card, ops):
    from ray_tpu_torch.rl import (CartPole, DQNConfig, MemoryCue, Pendulum,
                                  PGConfig, R2D2Config, RainbowConfig,
                                  SACConfig, TD3Config)

    log("== offpolicy: DQN and Rainbow on CartPole at 128 x 32 with a 100k "
        "buffer, PG on CartPole at 128 x 128, TD3 and SAC on Pendulum, R2D2 "
        "on MemoryCue, at their configs' sizes; a Rainbow iteration against "
        "the CPU")
    kernels = (ops.flash_fwd, ops.flash_bwd_dq, ops.flash_bwd_dkv)
    with fp32_ieee():
        out = {"card_equals_cpu": rainbow_card_equals_cpu(card)}
        for kernel in kernels:
            kernel.launches = 0
        runs = (("dqn", "DQN (double), CartPole 128 x 32",
                 DQNConfig(env=CartPole, **OFF_DQN)),
                ("rainbow", "Rainbow, CartPole 128 x 32",
                 RainbowConfig(env=CartPole, **OFF_DQN)),
                ("pg", "PG, CartPole 128 x 128",
                 PGConfig(env=CartPole, **OFF_PG)),
                ("td3", "TD3, Pendulum 16 x 16",
                 TD3Config(env=Pendulum, seed=0)),
                ("sac", "SAC, Pendulum 16 x 16",
                 SACConfig(env=Pendulum, seed=0)),
                ("r2d2", "R2D2, MemoryCue 16 x 20",
                 R2D2Config(env=MemoryCue, seed=0)))
        for name, what, cfg in runs:
            out[name] = off_run(card, what, cfg,
                                getattr(cfg, "learn_start", 0))
        launches = {k.__name__: k.launches for k in kernels}
    if any(launches.values()):
        raise AssertionError(f"the offpolicy path launched {launches}")
    return launches, out


# -- rl_breadth: IMPALA / APPO, multi-agent, offline RL, bandits -----------

def breadth_copy_learner(src, dst):
    """``src``'s params (and, where it has them, targets, Adam state,
    buffer, envs and env-step count) onto ``dst``, a twin on another
    device (copies)."""
    from ray_tpu_torch.rl.policy import tree_map

    if hasattr(src, "buffer"):
        off_copy(src, dst)
        return
    dst.params = tree_map(lambda x: x.to(dst.device, copy=True), src.params)
    dst.opt_state = dst.optimizer.init(dst.params)


def share_of_norm(got, want):
    """The largest ``|got - want| / |want|`` over matching tensors (norms),
    ``got`` on the card."""
    return max(float((g.cpu().double() - w.double()).norm()
                     / w.double().norm().clamp_min(1e-30))
               for g, w in zip(got, want))


def impala_card_equals_cpu(card):
    """An IMPALA iteration (CartPole, 16 envs x 8 steps) on the card and on
    the CPU from the same weights and draws, full fp32: actions, rewards,
    dones equal (an env whose sampled action is a near-tie of pi + noise,
    top two under RL_TIE, is compared up to there), observations and
    behaviour log-probs within the env-step bound; the card's own mean rho
    1 within BREADTH_RHO; then from the CPU's batch on both sides V-trace's
    vs and pg_adv, the loss and the gradients before and after the
    global-norm clip within BREADTH_TOL["impala"] of a norm."""
    from ray_tpu_torch.rl import CartPole, ImpalaConfig
    from ray_tpu_torch.rl.learner import value_and_grad
    from ray_tpu_torch.rl.policy import tree_map
    from ray_tpu_torch.rl.ppo import clip_by_global_norm

    sides = {dev: ImpalaConfig(env=CartPole, device=dev,
                               **BREADTH_IMPALA_PARITY).build()
             for dev in ("cpu", "cuda")}
    cpu, gpu = sides["cpu"], sides["cuda"]
    n, steps = cpu.config.num_envs, cpu.config.rollout_length
    breadth_copy_learner(cpu, gpu)
    gen = torch.Generator().manual_seed(3)
    first = cpu.env.reset_draws(n, gen)
    draws = [{"noise": cpu.policy.draw_noise(n, gen),
              "reset": cpu.env.reset_draws(n, gen)} for _ in range(steps)]
    batches = {}
    for dev, algo in sides.items():
        def to(tree):
            return tree_map(lambda x: x.to(dev), tree)
        algo.env_states, algo.obs = algo.env.reset_given(to(first))
        batches[dev] = algo.collect(to(draws))
    on_card("rl_breadth IMPALA card = CPU, the rollout")
    cb = batches["cpu"]
    gb = tree_map(lambda x: x.cpu(), batches["cuda"])
    diverged, gap = rl_diverged(cpu.policy, cpu.params, cb, draws,
                                gb["action"])
    if gap > RL_TIE:
        raise AssertionError(f"rl_breadth: an IMPALA card action differs "
                             f"where the top two were {gap:.3e} apart")
    t = torch.arange(steps)[:, None]
    seen, acted = t <= diverged, t < diverged
    errs = {}
    for key, mask in (("obs", seen), ("action", acted), ("reward", acted),
                      ("done", acted), ("logp", seen)):
        got, want = gb[key][mask], cb[key][mask]
        if key in ("action", "reward", "done"):
            if not torch.equal(got, want):
                raise AssertionError(f"rl_breadth: the card's IMPALA "
                                     f"{key} differs from the CPU's")
            continue
        errs[key] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=OFF_PARITY_TOL[0],
                              atol=OFF_PARITY_TOL[1]):
            raise AssertionError(f"rl_breadth: the card's IMPALA {key} "
                                 f"differs by {errs[key]:.3e}")
    _, own, _ = value_and_grad(gpu.loss, gpu.params, batches["cuda"])
    errs["rho"] = abs(float(own["mean_rho"]) - 1.0)
    if errs["rho"] > BREADTH_RHO:
        raise AssertionError(f"rl_breadth: the card's inline mean rho is "
                             f"{errs['rho']:.3e} from 1")
    parts = {}
    for dev, algo in sides.items():
        total, aux, grads = value_and_grad(
            algo.loss, algo.params, tree_map(lambda x: x.to(dev), cb))
        parts[dev] = {"loss": [total], "vs": [aux["vs"]],
                      "pg_adv": [aux["pg_adv"]], "grads": grads,
                      "clipped": clip_by_global_norm(
                          grads, algo.config.max_grad_norm)}
    on_card("rl_breadth IMPALA card = CPU, the loss and gradients")
    for key, want in parts["cpu"].items():
        errs[key] = share_of_norm(parts["cuda"][key], want)
    worst = max(errs[k] for k in parts["cpu"])
    if worst > BREADTH_TOL["impala"]:
        raise AssertionError(f"rl_breadth: the card's IMPALA loss parts "
                             f"differ from the CPU's: {errs}")
    n_div = int((diverged < steps).sum())
    log(f"  card = CPU: IMPALA, CartPole {n} envs x {steps} steps, fp32 (no "
        f"TF32): actions, rewards, dones equal ({n_div} envs compared up to "
        f"a near-tie action, top two {gap:.2e} apart), observations max "
        f"|diff| {errs['obs']:.3e}, log-probs {errs['logp']:.3e}; the "
        f"card's mean rho 1 + {errs['rho']:.2e}; from one batch: vs "
        f"{errs['vs']:.2e}, pg_adv {errs['pg_adv']:.2e}, loss "
        f"{errs['loss']:.2e}, gradients {errs['grads']:.2e}, clipped "
        f"{errs['clipped']:.2e} of a norm [{card}]")
    return {"envs": n, "steps": steps, "near_tie_envs": n_div,
            "max_err": errs}


def qmix_card_equals_cpu(card):
    """A QMIX iteration (SpreadLine(4), 8 envs x 8 steps, buffer 512,
    past the gate) on the card and on the CPU from the same weights,
    buffer and draws, full fp32: actions equal but where the CPU's Q top
    two of that agent were within OFF_TIE (that env compared up to
    there), the written rows within the env-step bound; then from the
    CPU's buffer on both sides and the same sampled slots the first
    update's batch, Q_tot, loss and gradients within
    BREADTH_TOL["qmix_first"] of a norm, and after the 4 updates the loss
    and params within BREADTH_TOL's measured drift."""
    from ray_tpu_torch.rl import QMIXConfig, SpreadLine, mlp_apply, replay
    from ray_tpu_torch.rl.learner import value_and_grad
    from ray_tpu_torch.rl.policy import tree_leaves, tree_map

    sides = {dev: QMIXConfig(env=SpreadLine, device=dev,
                             **BREADTH_QMIX_PARITY).build()
             for dev in ("cpu", "cuda")}
    cpu, gpu = sides["cpu"], sides["cuda"]
    cfg = cpu.config
    n, steps, b = cfg.num_envs, cfg.rollout_steps, cfg.batch_size
    n_agents, n_act = cpu.n_agents, cpu.env.action_size
    cpu.collect()                           # the buffer at learn_start
    cpu._total_env_steps = n * steps
    breadth_copy_learner(cpu, gpu)
    gen = torch.Generator().manual_seed(5)
    draws = [{"uniform": torch.rand(n, n_agents, generator=gen),
              "random": torch.randint(n_act, (n, n_agents), generator=gen),
              "reset": cpu.env.reset_draws(n, gen)} for _ in range(steps)]
    cursor = cpu.buffer["cursor"]
    cpu.collect(draws)
    gpu.collect(tree_map(lambda x: x.cuda(), draws))
    on_card("rl_breadth QMIX card = CPU, the collect")
    crow, grow = (off_written(a, cursor, steps) for a in (cpu, gpu))
    differs = (grow["action"] != crow["action"]).any(-1)      # [T, n]
    first = torch.where(differs.any(0), differs.int().argmax(0),
                        torch.full((n,), steps))
    gap = 0.0
    for env in torch.nonzero(first < steps).flatten().tolist():
        t = int(first[env])
        top = mlp_apply(cpu.params["q"],
                        crow["obs"][t, env]).topk(2).values      # [N, 2]
        agents = grow["action"][t, env] != crow["action"][t, env]
        gap = max(gap, float((top[:, 0] - top[:, 1])[agents].max()))
    if gap > OFF_TIE:
        raise AssertionError(f"rl_breadth: a QMIX card action differs "
                             f"where the Q top two were {gap:.3e} apart")
    t = torch.arange(steps)[:, None]
    seen, acted = t <= first, t < first
    errs = {}
    for key, mask in (("obs", seen), ("state", seen), ("action", acted),
                      ("reward", acted), ("done", acted),
                      ("next_obs", acted)):
        got, want = grow[key][mask], crow[key][mask]
        errs[key] = float((got - want).abs().float().max()) \
            if got.numel() else 0.0
        ok = (torch.equal(got, want) if key in ("action", "done")
              else torch.allclose(got, want, rtol=OFF_PARITY_TOL[0],
                                  atol=OFF_PARITY_TOL[1]))
        if not ok:
            raise AssertionError(f"rl_breadth: the card's QMIX {key} "
                                 f"differs by {errs[key]:.3e}")
    # the updates, from the CPU's buffer on both sides
    breadth_copy_learner(cpu, gpu)
    size = cpu.buffer["size"]
    idx = [torch.randint(size, (b,), generator=gen)
           for _ in range(cfg.num_updates)]
    parts = {}
    for dev, algo in sides.items():
        batch, got_idx = replay.sample(algo.buffer, b,
                                       draw={"idx": idx[0].to(dev)})
        loss, _, grads = value_and_grad(
            lambda p, bt: (algo.td_loss(p, algo.target_params, bt), None),
            algo.params, batch)
        parts[dev] = {"batch": [batch[k] for k in sorted(batch)],
                      "idx": got_idx, "q_tot": [algo.q_tot(algo.params,
                                                           batch)],
                      "loss": [loss], "grads": grads}
    on_card("rl_breadth QMIX card = CPU, the first update's parts")
    if not torch.equal(parts["cuda"]["idx"].cpu(), parts["cpu"]["idx"]):
        raise AssertionError("rl_breadth: the card's QMIX sampled other "
                             "slots")
    first_errs = {k: share_of_norm(parts["cuda"][k], parts["cpu"][k])
                  for k in ("batch", "q_tot", "loss", "grads")}
    errs["first"] = first_errs
    if max(first_errs.values()) > BREADTH_TOL["qmix_first"]:
        raise AssertionError(f"rl_breadth: the card's first QMIX update "
                             f"differs from the CPU's: {first_errs}")
    losses = {dev: algo.learn([{"idx": i.to(dev)} for i in idx])
              for dev, algo in sides.items()}
    on_card("rl_breadth QMIX card = CPU, the updates")
    later = {"loss": float((losses["cuda"].cpu() - losses["cpu"]).abs()
                           / losses["cpu"].abs()),
             "params_in_steps": max(
                 float((g.cpu() - c).abs().max()) / cfg.lr
                 for g, c in zip(tree_leaves(gpu.params),
                                 tree_leaves(cpu.params)))}
    errs["later"] = later
    if later["loss"] > BREADTH_TOL["qmix_loss"] or \
            later["params_in_steps"] > BREADTH_TOL["qmix_params_in_steps"]:
        raise AssertionError(f"rl_breadth: after {cfg.num_updates} QMIX "
                             f"updates the card differs from the CPU: "
                             f"{later}")
    n_div = int((first < steps).sum())
    log(f"  card = CPU: QMIX, SpreadLine({n_agents}) {n} envs x {steps} "
        f"steps, buffer {cfg.buffer_capacity}, batch {b}, fp32: actions "
        f"equal ({n_div} envs compared up to a Q near-tie, top two "
        f"{gap:.2e} apart), rows max |diff| obs {errs['obs']:.2e}, reward "
        f"{errs['reward']:.2e}; first update: slots equal, batch "
        f"{first_errs['batch']:.2e}, Q_tot {first_errs['q_tot']:.2e}, loss "
        f"{first_errs['loss']:.2e}, gradients {first_errs['grads']:.2e} of "
        f"a norm; after {cfg.num_updates} updates loss {later['loss']:.2e} "
        f"relative, params {later['params_in_steps']:.4f} of an Adam step "
        f"(lr) [{card}]")
    return {"envs": n, "steps": steps, "near_tie_envs": n_div,
            "max_err": errs}


def lints_payoff_gap(algo, draws, t):
    """The CPU's top-two gap of the Thompson payoffs at step ``t`` of
    ``draws``, from the posterior after steps ``0..t-1`` (relative to the
    largest payoff's magnitude); → (gap, the CPU algorithm replayed to
    step ``t``)."""
    replay_algo = dataclasses.replace(algo.config, steps_per_iter=t).build()
    replay_algo.run({k: v[:t] for k, v in draws.items()})
    A, b = replay_algo.A, replay_algo.b
    x = replay_algo.env.context(draws["context"][t])
    theta = torch.linalg.solve(A, b[..., None])
    L = torch.linalg.cholesky(A)
    pert = torch.linalg.solve_triangular(L.mT, draws["z"][t][..., None],
                                         upper=True)
    pay = (theta + algo.config.sigma * pert)[..., 0] @ x
    top = pay.topk(2).values
    return float((top[0] - top[1]) / top[0].abs().clamp_min(1e-30)), \
        replay_algo


def lints_card_equals_cpu(card):
    """LinTS, 512 steps on the card and on the CPU from the same bandit
    weights and draws, full fp32: the arms equal, but where the CPU's
    Thompson payoffs had their top two within BREADTH_TIE["lints"]
    (printed; both sides are then compared up to that step), and A and b
    within BREADTH_TOL["lints"] relative to their largest entry."""
    from ray_tpu_torch.rl import LinearContextBandit, LinTSConfig
    from ray_tpu_torch.rl.policy import tree_map

    weights = LinearContextBandit(device="cpu").weights.numpy()
    cfg = LinTSConfig(env=lambda device: LinearContextBandit(
        weights=weights, device=device), seed=0)
    sides = {dev: dataclasses.replace(cfg, device=dev).build()
             for dev in ("cpu", "cuda")}
    draws = sides["cpu"].draw()
    arms = {}
    for dev, algo in sides.items():
        arms[dev] = algo.run(tree_map(lambda x: x.to(dev), draws))[2].cpu()
    on_card("rl_breadth LinTS card = CPU")
    differs = torch.nonzero(arms["cuda"] != arms["cpu"]).flatten()
    steps, gap, cpu, gpu = cfg.steps_per_iter, None, sides["cpu"], \
        sides["cuda"]
    if differs.numel():
        steps = int(differs[0])
        gap, cpu = lints_payoff_gap(sides["cpu"], draws, steps)
        if gap > BREADTH_TIE["lints"]:
            raise AssertionError(f"rl_breadth: a LinTS card arm differs at "
                                 f"step {steps}, where the payoffs' top two "
                                 f"were {gap:.3e} apart")
        gpu = dataclasses.replace(cfg, device="cuda",
                                  steps_per_iter=steps).build()
        gpu.run(tree_map(lambda x: x[:steps].cuda(), draws))
        log(f"  LinTS: the card's arm parts from the CPU's at step {steps} "
            f"of {cfg.steps_per_iter}, a near-tie (payoffs' top two "
            f"{gap:.2e} apart, relative); compared up to there")
    errs = {k: float((getattr(gpu, k).cpu() - getattr(cpu, k)).abs().max()
                     / getattr(cpu, k).abs().max())
            for k in ("A", "b")}
    if max(errs.values()) > BREADTH_TOL["lints"]:
        raise AssertionError(f"rl_breadth: the card's LinTS posteriors "
                             f"differ from the CPU's: {errs}")
    log(f"  card = CPU: LinTS (d {weights.shape[1]}, K {weights.shape[0]}), "
        f"{cfg.steps_per_iter} steps, fp32: arms equal over {steps} steps "
        f"({'no near-tie' if gap is None else f'then a near-tie {gap:.2e}'}"
        f"); A {errs['A']:.2e}, b {errs['b']:.2e} of the largest entry "
        f"[{card}]")
    return {"steps": cfg.steps_per_iter, "compared_steps": steps,
            "near_tie_gap": gap, "max_err": errs}


def synced_ms(fn):
    """Wall time (ms) of one call of ``fn``, synced before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def count_syncs(fn):
    """Host-device synchronizations in one call of ``fn``, as CUDA's sync
    debug mode reports them (one warning each)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def breadth_run(card, what, make, *, steps, unit, loss_key, warm_until=None,
                split=(), ops=(), profiled=None):
    """Warm iterations (one, or until ``warm_until(algo)``),
    BREADTH_TIMED_ITERS timed ones (synced by the iteration's read of its
    metrics), the ``split`` parts of one iteration each synced, one
    profiled iteration, the host's ops and kernels (``ops``: (name, fn,
    per) → per call / per), the syncs of one iteration and peak memory;
    the loss named ``loss_key`` must be finite and nonzero.  ``steps``
    units (env steps, rows, bandit steps) an iteration.  ``ops`` entries
    are (name, prepare, per): ``prepare(algo)`` makes, outside the count,
    the call that is counted.  ``profiled``: (name, prepare) of a part of
    an iteration to profile instead of the whole (the profiler's event
    processing grows with the ops it saw), its busy share against its own
    unprofiled wall (the median of 3 synced calls)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    algo = make()
    warm, history = 0, []
    while True:
        res = algo.train()
        history.append(res)
        warm += 1
        if warm_until is None or warm_until(algo):
            break
    warm_s = time.perf_counter() - t0
    walls = []
    for _ in range(BREADTH_TIMED_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = algo.train()
        walls.append((time.perf_counter() - t0) * 1e3)
        history.append(res)
    loss = res[loss_key]
    loss = float(np.mean(loss)) if isinstance(loss, list) else loss
    if not (np.isfinite(loss) and loss != 0):
        raise AssertionError(f"{what}: {loss_key} {res[loss_key]} is not a "
                             f"finite, nonzero loss")
    parts, prev = {}, None
    for name, fn in split:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prev = fn(algo, prev)
        torch.cuda.synchronize()
        parts[f"{name}_ms"] = (time.perf_counter() - t1) * 1e3
    wall = float(np.median(walls))
    part, part_fn, part_wall = "iteration", algo.train, wall
    if profiled is not None:
        part, part_fn = profiled[0], profiled[1](algo)
        part_wall = float(np.median([synced_ms(part_fn)
                                     for _ in range(3)]))
    kernels_ms = profile_step(card, f"{what}: one profiled {part}",
                              part_fn, part_wall, n=6)
    counts = {}
    for name, fn, per in ops:
        n_ops, n_kernels = host_ops(fn(algo))
        counts[f"ops_per_{name}"] = n_ops / per
        counts[f"kernels_per_{name}"] = n_kernels / per
    syncs = count_syncs(algo.train)
    out = {f"{unit}_per_s": steps / wall * 1e3, "iteration_ms": walls,
           "warm_iterations": warm, "warm_s": warm_s, **parts,
           loss_key: res[loss_key], **counts, "syncs_per_iteration": syncs,
           "device_busy_ms": sum(kernels_ms.values()) if kernels_ms
           else None,
           "largest_kernels_ms": dict(top_kernels(kernels_ms, 4)),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    out["device_busy_share"] = (out["device_busy_ms"] / part_wall
                                if kernels_ms else None)
    if profiled is not None:
        out["profiled"], out[f"{part}_ms"] = part, part_wall
    log(f"  {what}: {out[f'{unit}_per_s']:.0f} {unit}/s (iterations "
        f"{', '.join(f'{w:.1f}' for w in walls)} ms after {warm} warm, "
        f"{warm_s:.2f} s); "
        + "".join(f"{k[:-3]} {v:.1f} ms, " for k, v in parts.items())
        + "".join(f"{v:.0f} {k.replace('_per_', ' a ')}, "
                  for k, v in counts.items())
        + f"{syncs} syncs an iteration; {loss_key} {loss:.4g}; peak "
        f"{out['peak_gib']:.3f} GiB [{card}]")
    return algo, out, history


@functools.lru_cache(maxsize=None)
def expert_dataset():
    """The 20,000-row CartPole dataset of tests/test_offline_rl.py's
    scripted expert, collected on the card once (the rl_breadth phase's
    offline RL and the rl_rest phase's Decision Transformer train on it).
    → (columns, seconds the collection took)."""
    from ray_tpu_torch.rl import CartPole, collect_dataset

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dataset = collect_dataset(
        CartPole, lambda obs, draws: (obs[:, 2] + obs[:, 3] > 0).int(),
        n_steps=BREADTH_DATASET_ROWS, num_envs=BREADTH_DATASET_ENVS)
    collect_s = time.perf_counter() - t0
    if len(dataset["obs"]) != BREADTH_DATASET_ROWS or not np.all(
            np.isfinite(dataset["obs"])):
        raise AssertionError("the offline dataset is not 20,000 finite "
                             "rows")
    return dataset, collect_s


def phase_rl_breadth(card, ops):
    from ray_tpu_torch.rl import (BCConfig, CartPole, CQLConfig, CRRConfig,
                                  APPOConfig, ImpalaConfig,
                                  IndependentPPOConfig, LinTSConfig,
                                  LinUCBConfig, LinearContextBandit,
                                  MADDPGConfig, MARWILConfig, QMIXConfig,
                                  SpreadLine, SpreadLineContinuous,
                                  importance_sampling_estimate)

    log("== rl_breadth: IMPALA and APPO on CartPole 64 x 64, IndependentPPO "
        "on SpreadLine(4) 32 x 64, QMIX on SpreadLine(4), MADDPG on "
        "SpreadLineContinuous(3), BC / MARWIL / CQL / CRR on a 20,000-row "
        "CartPole dataset, LinUCB and LinTS, at their configs' defaults; "
        "IMPALA, QMIX and LinTS against the CPU")
    kernels = (ops.flash_fwd, ops.flash_bwd_dq, ops.flash_bwd_dkv)
    out = {}
    with fp32_ieee():
        out["card_equals_cpu"] = {"impala": impala_card_equals_cpu(card),
                                  "qmix": qmix_card_equals_cpu(card),
                                  "lints": lints_card_equals_cpu(card)}
        for kernel in kernels:
            kernel.launches = 0
        for name, cfg_cls in (("impala", ImpalaConfig),
                              ("appo", APPOConfig)):
            cfg = cfg_cls(env=CartPole, seed=0)
            _, out[name], hist = breadth_run(
                card, f"{name.upper()}, CartPole {cfg.num_envs} x "
                f"{cfg.rollout_length}", cfg.build,
                steps=cfg.num_envs * cfg.rollout_length, unit="env_steps",
                loss_key="vf_loss",
                split=(("collect", lambda a, _: a.collect()),
                       ("update", lambda a, batch: a.learn(batch))),
                ops=(("collect_step", lambda a: a.collect,
                      cfg.rollout_length),
                     ("update", lambda a: functools.partial(
                         a.learn, a.collect()), 1)))
            rho = max(abs(r["mean_rho"] - 1.0) for r in hist)
            out[name]["max_rho_err"] = rho
            if rho > BREADTH_RHO:
                raise AssertionError(f"{name}: mean rho {rho:.3e} from 1")
        cfg = IndependentPPOConfig(env=SpreadLine, seed=0)
        _, out["ippo"], _ = breadth_run(
            card, f"IndependentPPO, SpreadLine(4) {cfg.num_envs} x "
            f"{cfg.rollout_length}", cfg.build,
            steps=cfg.num_envs * cfg.rollout_length * BREADTH_AGENTS,
            unit="env_steps",
            loss_key="loss_per_agent",
            split=(("collect", lambda a, _: a.collect()),
                   ("update", lambda a, traj: a.learn(traj))),
            ops=(("collect_step", lambda a: a.collect, cfg.rollout_length),
                 ("epoch", lambda a: functools.partial(a.learn, a.collect()),
                  cfg.num_sgd_epochs)))
        shared = dataclasses.replace(cfg, share_parameters=True).build()
        res = shared.train()
        w = shared.params["torso"][0]["w"]
        if not (np.all(np.isfinite(res["loss_per_agent"]))
                and not torch.equal(w[0], w[1])):
            raise AssertionError("IndependentPPO, shared init: the copies "
                                 "did not part or a loss is not finite")
        out["ippo"]["shared_init_loss_per_agent"] = res["loss_per_agent"]
        log(f"  IndependentPPO, share_parameters=True: losses "
            f"{[round(x, 4) for x in res['loss_per_agent']]}, the copies "
            f"parted after one iteration")
        del shared
        for name, cfg in (("qmix", QMIXConfig(env=SpreadLine, seed=0)),
                          ("maddpg", MADDPGConfig(env=SpreadLineContinuous,
                                                  seed=0))):
            _, out[name], _ = breadth_run(
                card, f"{name.upper()}, {cfg.env.__name__} {cfg.num_envs} x "
                f"{cfg.rollout_steps}, {cfg.num_updates} updates of "
                f"{cfg.batch_size}", cfg.build,
                steps=cfg.num_envs * cfg.rollout_steps, unit="env_steps",
                loss_key="td_loss" if name == "qmix" else "critic_loss",
                warm_until=lambda a: a.buffer["size"] >= a.config.learn_start,
                split=(("collect", lambda a, _: a.collect()),
                       ("updates", lambda a, _: a.learn())),
                ops=(("collect_step", lambda a: a.collect,
                      cfg.rollout_steps),
                     ("update", lambda a: a.learn, cfg.num_updates)))
        dataset, collect_s = expert_dataset()
        out["dataset"] = {"rows": BREADTH_DATASET_ROWS,
                          "envs": BREADTH_DATASET_ENVS,
                          "collect_s": collect_s,
                          "rows_per_s": BREADTH_DATASET_ROWS / collect_s}
        log(f"  the dataset: {BREADTH_DATASET_ROWS} rows from "
            f"{BREADTH_DATASET_ENVS} envs of the scripted expert in "
            f"{collect_s:.2f} s")
        rows = (BREADTH_DATASET_ROWS // 256) * 256
        for name, cfg_cls, loss_key, kw in (
                ("bc", BCConfig, "bc_loss", {}),
                ("marwil", MARWILConfig, "policy_loss", {}),
                ("cql", CQLConfig, "cql_loss", {}),
                ("crr", CRRConfig, "critic_loss", {})):
            cfg = cfg_cls(env=CartPole, dataset=dataset, seed=0, **kw)
            algo, out[name], _ = breadth_run(
                card, f"{name.upper()}, one epoch of {rows // 256} "
                f"minibatches of 256", cfg.build, steps=rows, unit="rows",
                loss_key=loss_key,
                ops=(("minibatch", lambda a: functools.partial(
                    a._step, torch.arange(256, device=a.device)), 1),))
            if name == "bc":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                est = importance_sampling_estimate(
                    algo.policy, algo.params, dataset,
                    np.zeros(BREADTH_DATASET_ROWS))
                est_ms = (time.perf_counter() - t0) * 1e3
                if not np.isfinite(est["v_target"]):
                    raise AssertionError(f"the IS estimate is not finite: "
                                         f"{est}")
                out["is_estimate"] = {**est, "ms": est_ms}
                log(f"  IS estimate of BC's policy against the expert's "
                    f"data: {est} in {est_ms:.1f} ms")
            del algo
        for name, cfg_cls in (("linucb", LinUCBConfig),
                              ("lints", LinTSConfig)):
            cfg = cfg_cls(env=LinearContextBandit, seed=0)
            _, out[name], hist = breadth_run(
                card, f"{name}, d 8, K 4, {cfg.steps_per_iter} steps",
                cfg.build, steps=cfg.steps_per_iter, unit="steps",
                loss_key="mean_regret",
                ops=(("step", lambda a: a.run, cfg.steps_per_iter),))
            regret = [r["mean_regret"] for r in hist]
            out[name]["regret_by_iteration"] = regret
            if not regret[-1] < regret[0]:
                raise AssertionError(f"{name}: regret did not fall: "
                                     f"{regret}")
        launches = {k.__name__: k.launches for k in kernels}
    if any(launches.values()):
        raise AssertionError(f"the rl_breadth path launched {launches}")
    return launches, out


# -- rl_rest: ES / ARS, MAML, Dreamer, DT, AlphaZero, SlateQ ---------------

def rest_to(tree, device):
    """Copies on ``device`` of a tree of tensors (dicts, lists, tuples)."""
    from ray_tpu_torch.rl.policy import tree_map

    return tree_map(lambda x: x.to(device, copy=True), tree)


def maml_card_equals_cpu(card):
    """A MAML meta-step (GoalDirection, 4 tasks x 4 envs x 16 steps, one
    inner step) on the card and on the CPU from the same weights and
    draws, full fp32: the meta-loss within REST_TOL["maml"] (relative),
    the pre- and post-adaptation reward means within
    REST_TOL["maml_rewards"], the second-order meta-gradient, which runs
    through both rollouts, within REST_TOL["maml"] of a norm."""
    from ray_tpu_torch.rl import MAMLConfig

    cpu = MAMLConfig(device="cpu", **REST_MAML_PARITY).build()
    gpu = MAMLConfig(device="cuda", **REST_MAML_PARITY).build()
    gpu.params = rest_to(cpu.params, gpu.device)
    draws = cpu.meta_draws()
    want = cpu.meta_gradient(draws)
    got = gpu.meta_gradient(rest_to(draws, gpu.device))
    on_card("the MAML meta-gradient")
    err = {"loss": share_of_norm(got[:1], want[:1]),
           "rewards": max(abs(float(g) - float(w))
                          for g, w in zip(got[1:3], want[1:3])),
           "meta_gradient": share_of_norm(got[3], want[3])}
    log(f"  MAML card = CPU (4 tasks x 4 envs): meta-loss {float(want[0]):.5g}"
        f" ({err['loss']:.2e} apart), rewards {err['rewards']:.2e} apart, "
        f"the meta-gradient {err['meta_gradient']:.2e} of a norm (<= "
        f"{REST_TOL['maml']:g}) [{card}]")
    if max(err["loss"], err["meta_gradient"]) > REST_TOL["maml"] \
            or err["rewards"] > REST_TOL["maml_rewards"]:
        raise AssertionError(f"MAML: the card's meta-step differs from the "
                             f"CPU's: {err}")
    return {"max_err": err}


def alphazero_card_equals_cpu(card):
    """An AlphaZero self-play (TicTacToe, 4 games at 8 simulations a move,
    the first 2 moves sampled by visits) on the card and on the CPU from
    the same weights and draws, full fp32: every move's visit
    distribution, the boards (so every action), the outcomes and the live
    masks equal."""
    from ray_tpu_torch.rl import AlphaZeroConfig

    cpu = AlphaZeroConfig(device="cpu", **REST_AZ_PARITY).build()
    gpu = AlphaZeroConfig(device="cuda", **REST_AZ_PARITY).build()
    gpu.params = rest_to(cpu.params, gpu.device)
    draws = cpu.selfplay_draws()
    want = cpu.selfplay(draws)
    got = gpu.selfplay(rest_to(draws, gpu.device))
    on_card("the AlphaZero self-play")
    same = {k: bool(torch.equal(got[k].cpu(), want[k])) for k in want}
    moves = int(want["live"].sum())
    log(f"  AlphaZero card = CPU (4 games x 8 simulations): {moves} moves; "
        f"visit distributions, boards, outcomes, live masks equal: {same} "
        f"[{card}]")
    if not all(same.values()):
        raise AssertionError(f"AlphaZero: the card's self-play differs from "
                             f"the CPU's: {same}")
    return {"max_err": {"moves": moves, **same}}


def dt_card_equals_cpu(card, dataset):
    """The Decision Transformer at the paper's width (DT_PAPER) on the card,
    through the flash kernels, and on the CPU, through reference
    attention, from the same weights, minibatch and draws, full fp32: one
    minibatch's loss and gradients within REST_TOL["dt"] of a norm, then
    one AdamW step on each side and one 500-step evaluation episode with
    the same return."""
    from ray_tpu_torch.rl import CartPole, DTConfig
    from ray_tpu_torch.rl.learner import value_and_grad

    kw = dict(DT_PAPER, steps_per_iter=1)
    cpu = DTConfig(env=CartPole, dataset=dataset, device="cpu", **kw).build()
    gpu = DTConfig(env=CartPole, dataset=dataset, device="cuda",
                   **kw).build()
    gpu.params = rest_to(cpu.params, gpu.device)
    gpu.opt_state = gpu.optimizer.init(gpu.params)
    idx = cpu.batch_draws()
    batch = {k: v[idx[0]] for k, v in cpu._windows.items()}
    want = value_and_grad(cpu.loss, cpu.params, batch)
    got = value_and_grad(gpu.loss, gpu.params, rest_to(batch, gpu.device))
    on_card("the DT minibatch's gradients")
    err = {"loss": share_of_norm([got[0]], [want[0]]),
           "gradients": share_of_norm(got[2], want[2])}
    cpu.training_step(idx)
    gpu.training_step(rest_to(idx, gpu.device))
    draws = cpu.eval_draws()
    target = cpu.config.target_return
    ret = (float(gpu.eval_rollout(target, rest_to(draws, gpu.device))),
           float(cpu.eval_rollout(target, draws)))
    log(f"  DT card = CPU (d_model 128, 1 head, 3 layers, batch 64): loss "
        f"{float(want[0]):.5g} ({err['loss']:.2e} apart), gradients "
        f"{err['gradients']:.2e} of a norm (<= {REST_TOL['dt']:g}); after "
        f"one AdamW step an evaluation episode returns {ret[0]:g} on the "
        f"card, {ret[1]:g} on the CPU [{card}]")
    if max(err.values()) > REST_TOL["dt"] or ret[0] != ret[1]:
        raise AssertionError(f"DT: the card differs from the CPU: {err}, "
                             f"returns {ret}")
    return {"max_err": err, "eval_return": ret[0]}


def slate_gap(algo, obs, e):
    """The CPU's top-two decomposed slate values of env ``e`` (a share of
    the largest)."""
    q = algo._q_items(algo.params, obs["user"][e], obs["topics"][e],
                      obs["quality"][e])
    v = torch.exp(algo.env.choice_logits(obs["user"][e], obs["topics"][e]))
    combos = algo._combos
    value = (v[combos] * q[combos]).sum(-1) / (
        np.exp(algo.env.no_click_logit) + v[combos].sum(-1))
    top = torch.topk(value, 2).values
    return float((top[0] - top[1]) / top[0].abs())


def slateq_card_equals_cpu(card):
    """A SlateQ iteration past the gate (RecSlateEnv, 16 envs x 8 steps,
    learn_start 64, batch 32, 4 updates, epsilon 0.3) on the card and on
    the CPU from the same weights, envs and draws, full fp32: the collect's
    slates, picks and dones equal (a greedy slate may part only at a
    near-tie of the CPU's decomposed values, top two under REST_TIE, and
    the rows are compared up to that step), users, documents and rewards
    within the env-step bound; then 4 updates from the CPU's buffer and
    indices on both sides: the loss within REST_TOL["slateq_loss"], the
    params within REST_TOL["slateq_params_in_steps"] of an Adam step."""
    from ray_tpu_torch.rl import SlateQConfig

    cpu = SlateQConfig(device="cpu", **REST_SLATE_PARITY).build()
    gpu = SlateQConfig(device="cuda", **REST_SLATE_PARITY).build()
    for name in ("params", "target_params", "env_states", "obs"):
        setattr(gpu, name, rest_to(getattr(cpu, name), gpu.device))
    gpu.opt_state = gpu.optimizer.init(gpu.params)
    draws = cpu.collect_draws()
    start_obs = cpu.obs
    cpu.collect(draws)
    gpu.collect(rest_to(draws, gpu.device))
    on_card("the SlateQ collect")
    E, T = cpu.config.num_envs, cpu.config.rollout_steps
    rows = {k: v[:E * T] for k, v in cpu.buffer["data"].items()}
    grows = {k: v[:E * T].cpu() for k, v in gpu.buffer["data"].items()}
    upto, gap = T, None
    for t in range(T):
        diff = torch.nonzero(~torch.all(
            rows["slate"][t * E:(t + 1) * E]
            == grows["slate"][t * E:(t + 1) * E], -1))
        if len(diff):
            e = int(diff[0])
            obs = start_obs if t == 0 else {
                "user": rows["next_user"][(t - 1) * E:t * E],
                "topics": rows["next_topics"][(t - 1) * E:t * E],
                "quality": rows["next_quality"][(t - 1) * E:t * E]}
            gap = slate_gap(cpu, obs, e)
            log(f"  SlateQ card = CPU: env {e}'s slate parts at step {t}; "
                f"the CPU's top-2 values there {gap:.3e} apart (a tie if < "
                f"{REST_TIE:g})")
            if gap >= REST_TIE:
                raise AssertionError(f"SlateQ: env {e}'s slate differs at "
                                     f"step {t}, not at a tie")
            upto = t
            break
    n = upto * E
    for k in ("slate", "pick", "done"):
        if not torch.equal(grows[k][:n], rows[k][:n]):
            raise AssertionError(f"SlateQ: the collect's {k} differ")
    env_err = max((float(((grows[k][:n] - rows[k][:n]).abs()
                          - 1e-5 * rows[k][:n].abs()).max()) if n else 0.0)
                  for k in ("user", "topics", "reward", "next_user"))
    if env_err > 1e-6:
        raise AssertionError(f"SlateQ: the collect's rows differ by "
                             f"{env_err:.3e} past the env-step bound")
    # the updates, from the CPU's buffer and indices on both sides
    gpu.buffer = rest_to(cpu.buffer["data"], gpu.device)
    gpu.buffer = {"data": gpu.buffer, "cursor": cpu.buffer["cursor"],
                  "size": cpu.buffer["size"],
                  "capacity": cpu.buffer["capacity"]}
    before = rest_to(cpu.params, gpu.device)
    gpu.params = rest_to(cpu.params, gpu.device)
    gpu.target_params = rest_to(cpu.target_params, gpu.device)
    gpu.opt_state = gpu.optimizer.init(gpu.params)
    gen = torch.Generator().manual_seed(5)
    upd = [{"idx": torch.randint(cpu.buffer["size"], (32,), generator=gen)}
           for _ in range(cpu.config.num_updates)]
    want = cpu.learn(upd)
    got = gpu.learn(rest_to(upd, gpu.device))
    on_card("the SlateQ updates")
    from ray_tpu_torch.rl.policy import tree_leaves

    lr = cpu.config.lr
    steps = max(float((g.cpu() - w).abs().max()) / lr
                for g, w in zip(tree_leaves(gpu.params),
                                tree_leaves(cpu.params)))
    moved = max(float((g - b).abs().max()) / lr
                for g, b in zip(tree_leaves(gpu.params),
                                tree_leaves(before)))
    err = {"rows_compared": n, "tie_gap": gap, "env": env_err,
           "loss": share_of_norm([got], [want]), "params_in_steps": steps}
    log(f"  SlateQ card = CPU (16 envs x 8 steps, 4 updates of 32): "
        f"{n} rows equal (slates, picks, dones) and within the env-step "
        f"bound; the last update's loss {float(want):.5g} "
        f"({err['loss']:.2e} apart), the params {steps:.2e} of an Adam "
        f"step apart after the params moved {moved:.2f} steps [{card}]")
    if err["loss"] > REST_TOL["slateq_loss"] \
            or steps > REST_TOL["slateq_params_in_steps"]:
        raise AssertionError(f"SlateQ: the card's updates differ from the "
                             f"CPU's: {err}")
    return {"max_err": err}


def dt_flash_against_reference(card, dataset, kernels):
    """One minibatch of the DT at the paper's width on the card through
    the flash kernels (3 launches of each a step: one forward, dQ and
    dK/dV per layer) and through reference attention, from the same
    weights: the loss and the gradients within REST_TOL["dt_flash"] of a
    norm."""
    from ray_tpu_torch.ops.attention import multi_head_attention
    from ray_tpu_torch.rl import CartPole, DTConfig
    from ray_tpu_torch.rl import dt as dt_module
    from ray_tpu_torch.rl.learner import value_and_grad
    import unittest.mock

    algo = DTConfig(env=CartPole, dataset=dataset, device="cuda",
                    **DT_PAPER).build()
    batch = {k: v[algo.batch_draws()[0]] for k, v in algo._windows.items()}
    for kernel in kernels:
        kernel.launches = 0
    flash = value_and_grad(algo.loss, algo.params, batch)
    on_card("the DT step through the flash kernels")
    launches = {k.__name__: k.launches for k in kernels}
    with unittest.mock.patch.object(
            dt_module, "multi_head_attention",
            functools.partial(multi_head_attention, impl="reference")):
        ref = value_and_grad(algo.loss, algo.params, batch)
    on_card("the DT step through reference attention")
    err = {"loss": share_of_norm([flash[0]], [ref[0].cpu()]),
           "gradients": share_of_norm(flash[2], [g.cpu() for g in ref[2]])}
    log(f"  DT (d_model 128, 1 head, 3 layers, batch 64 x 60 tokens) "
        f"flash against reference attention: loss {float(ref[0]):.5g} "
        f"({err['loss']:.2e} apart), gradients {err['gradients']:.2e} of a "
        f"norm (<= {REST_TOL['dt_flash']:g}); launches {launches} [{card}]")
    if max(err.values()) > REST_TOL["dt_flash"]:
        raise AssertionError(f"DT: flash and reference attention differ: "
                             f"{err}")
    if any(n != 3 for n in launches.values()):
        raise AssertionError(f"DT: one step launched {launches}, not 3 of "
                             f"each kernel")
    return {"max_err": err, "launches": launches}


def dt_paper_launches(card, algo, kernels):
    """The flash launches of one training_step (steps_per_iter AdamW steps)
    and of one evaluation episode of the DT at the paper's width: fwd = dq
    = dkv = 3 a step; fwd = 3 x max_episode_steps, dq = dkv = 0 an
    episode.  → the counts of both, summed by kernel."""
    steps = algo.config.steps_per_iter
    episode = algo.env.max_episode_steps
    counted = {}
    for what, fn, want in (
            ("training_step", algo.train,
             {"flash_fwd": 3 * steps, "flash_bwd_dq": 3 * steps,
              "flash_bwd_dkv": 3 * steps}),
            ("evaluation episode", lambda: algo.evaluate(1),
             {"flash_fwd": 3 * episode, "flash_bwd_dq": 0,
              "flash_bwd_dkv": 0})):
        for kernel in kernels:
            kernel.launches = 0
        fn()
        got = {k.__name__: k.launches for k in kernels}
        log(f"  DT at the paper's width: one {what} launched {got} (want "
            f"{want})")
        if got != want:
            raise AssertionError(f"DT: one {what} launched {got}, not "
                                 f"{want}")
        for name, n in got.items():
            counted[name] = counted.get(name, 0) + n
    return counted


def phase_rl_rest(card, ops):
    from ray_tpu_torch.rl import (AlphaZeroConfig, ARSConfig, CartPole,
                                  DreamerConfig, DTConfig, ESConfig,
                                  MAMLConfig, SlateQConfig)
    from ray_tpu_torch.rl.alpha_zero import dirichlet

    log("== rl_rest: ES and ARS on CartPole, MAML on GoalDirection, Dreamer "
        "on CartPole, the Decision Transformer at its defaults and at the "
        "paper's Gym width (flash kernels, fp32, d 128), AlphaZero on "
        "TicTacToe, SlateQ on RecSlateEnv, at their configs' defaults; "
        "MAML, AlphaZero, DT and SlateQ against the CPU")
    kernels = (ops.flash_fwd, ops.flash_bwd_dq, ops.flash_bwd_dkv)
    out = {}
    with fp32_ieee():
        dataset, _ = expert_dataset()
        t0 = time.perf_counter()
        out["card_equals_cpu"] = {
            "maml": maml_card_equals_cpu(card),
            "alphazero": alphazero_card_equals_cpu(card),
            "dt": dt_card_equals_cpu(card, dataset),
            "slateq": slateq_card_equals_cpu(card)}
        out["dt_flash_vs_reference"] = dt_flash_against_reference(
            card, dataset, kernels)
        out["checks_seconds"] = time.perf_counter() - t0
        log(f"  the card = CPU and flash = reference checks: "
            f"{out['checks_seconds']:.1f} s")

        def eval_forward(a):
            """The forward an evaluation step makes: one context."""
            w = a._windows
            return functools.partial(a._logits, a.params, w["rtg"][:1],
                                     w["obs"][:1], w["action"][:1])

        def dt_update(a):
            return functools.partial(a.step, a.batch_draws()[0])

        dt_ops = (("update", dt_update, 1), ("eval_forward", eval_forward, 1))

        def az_move(a):
            """One move's search for all the iteration's games."""
            cfg = a.config
            return functools.partial(
                a._mcts, a.params, a.game.initial_state(cfg.games_per_iter),
                dirichlet(cfg.dirichlet_alpha, (cfg.games_per_iter,
                                                a.game.num_actions),
                          a.generator), cfg.dirichlet_eps)

        es, ars = ESConfig(env=CartPole, seed=0), ARSConfig(env=CartPole,
                                                            seed=0)
        maml, dreamer = MAMLConfig(seed=0), DreamerConfig(env=CartPole,
                                                          seed=0)
        dt, dt_paper = (DTConfig(env=CartPole, dataset=dataset, seed=0),
                        DTConfig(env=CartPole, dataset=dataset, **DT_PAPER))
        az, slate = AlphaZeroConfig(seed=0), SlateQConfig(seed=0)
        runs = (
            ("es", f"ES, CartPole {es.num_perturbations} pairs x "
             f"{es.episodes_per_eval} episodes x {es.horizon} steps", es,
             dict(steps=2 * es.num_perturbations * es.episodes_per_eval
                  * es.horizon, unit="env_steps",
                  loss_key="episode_reward_mean",
                  split=(("evaluate", lambda a, _: a._evaluate_directions()),
                         ("final_eval", lambda a, _: a._mean_return())),
                  ops=(("rollout_step", lambda a: a._evaluate_directions,
                        es.horizon),))),
            ("ars", f"ARS, CartPole {ars.num_perturbations} pairs x "
             f"{ars.episodes_per_eval} episodes x {ars.horizon} steps", ars,
             dict(steps=2 * ars.num_perturbations * ars.episodes_per_eval
                  * ars.horizon, unit="env_steps",
                  loss_key="episode_reward_mean")),
            ("maml", f"MAML, GoalDirection {maml.meta_batch_size} tasks x "
             f"{maml.num_envs} envs x {maml.rollout_length} steps", maml,
             dict(steps=maml.meta_batch_size * maml.num_envs
                  * maml.rollout_length * (maml.inner_steps + 1),
                  unit="env_steps", loss_key="meta_loss",
                  split=(("draws", lambda a, _: a.meta_draws()),
                         ("meta_gradient", lambda a, d: a.meta_gradient(d)),
                         ("adam", lambda a, r: a.optimizer.update(
                             r[3], a.opt_state, a.params))),
                  ops=(("meta_step", lambda a: functools.partial(
                      a.meta_gradient, a.meta_draws()), 1),))),
            ("dreamer", f"Dreamer, CartPole {dreamer.num_envs} x "
             f"{dreamer.seq_len}, {dreamer.model_updates} + "
             f"{dreamer.ac_updates} updates of {dreamer.batch_size}", dreamer,
             dict(steps=dreamer.num_envs * dreamer.seq_len,
                  unit="env_steps", loss_key="model_loss",
                  warm_until=lambda a: a.buffer["size"]
                  >= a.config.learn_start,
                  split=(("collect", lambda a, _: a.collect()),
                         ("learn", lambda a, _: a.learn())),
                  ops=(("collect_step", lambda a: a.collect,
                        dreamer.seq_len),
                       ("update", lambda a: a.learn,
                        dreamer.model_updates + dreamer.ac_updates)))),
            ("dt", f"DT, d_model {dt.d_model}, {dt.n_heads} heads (head dim "
             f"{dt.d_model // dt.n_heads}: reference attention), "
             f"{dt.steps_per_iter} steps of {dt.batch_size}", dt,
             dict(steps=dt.steps_per_iter, unit="updates",
                  loss_key="action_ce_loss",
                  split=(("eval_episode", lambda a, _: a.eval_rollout(
                      a.config.target_return)),),
                  ops=dt_ops, profiled=("update", dt_update))),
            ("dt_paper", f"DT at the paper's width, d_model "
             f"{dt_paper.d_model}, 1 head, {dt_paper.n_layers} layers "
             f"(flash kernels), {dt_paper.steps_per_iter} steps of "
             f"{dt_paper.batch_size}", dt_paper,
             dict(steps=dt_paper.steps_per_iter, unit="updates",
                  loss_key="action_ce_loss",
                  split=(("eval_episode", lambda a, _: a.eval_rollout(
                      a.config.target_return)),),
                  ops=dt_ops, profiled=("update", dt_update))),
            ("alphazero", f"AlphaZero, TicTacToe {az.games_per_iter} games "
             f"x {az.num_simulations} simulations, {az.epochs_per_iter} "
             f"epochs of {az.batch_size}", az,
             dict(steps=az.games_per_iter, unit="games",
                  loss_key="total_loss",
                  split=(("selfplay", lambda a, _: a.selfplay()),
                         ("update", lambda a, games: a.learn(games))),
                  ops=(("move", az_move, 1),), profiled=("move", az_move))),
            ("slateq", f"SlateQ, RecSlateEnv {slate.num_envs} x "
             f"{slate.rollout_steps}, {slate.num_updates} updates of "
             f"{slate.batch_size}", slate,
             dict(steps=slate.num_envs * slate.rollout_steps,
                  unit="env_steps", loss_key="td_loss",
                  warm_until=lambda a: a.buffer["size"]
                  >= a.config.learn_start,
                  split=(("collect", lambda a, _: a.collect()),
                         ("updates", lambda a, _: a.learn())),
                  ops=(("collect_step", lambda a: a.collect,
                        slate.rollout_steps),
                       ("update", lambda a: a.learn, slate.num_updates)))))
        launches = None
        for name, what, cfg, kw in runs:
            for kernel in kernels:
                kernel.launches = 0
            t0 = time.perf_counter()
            algo, out[name], _ = breadth_run(card, what, cfg.build, **kw)
            ran = {k.__name__: k.launches for k in kernels}
            if name == "dt_paper":
                if not all(ran.values()):
                    raise AssertionError(f"DT at the paper's width launched "
                                         f"{ran}")
                launches = dt_paper_launches(card, algo, kernels)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ret = algo.evaluate(1)
                episode_ms = (time.perf_counter() - t1) * 1e3
                out[name]["eval_episode"] = {
                    "return": ret, "ms": episode_ms,
                    "steps_per_s": CartPole.max_episode_steps / episode_ms
                    * 1e3}
                log(f"  DT at the paper's width: an evaluation episode of "
                    f"{CartPole.max_episode_steps} steps in "
                    f"{episode_ms:.1f} ms, return {ret:g} [{card}]")
            elif any(ran.values()):
                raise AssertionError(f"the rl_rest path {name} launched "
                                     f"{ran}")
            out[name]["flash_launches"] = ran
            out[name]["seconds"] = time.perf_counter() - t0
            log(f"  {name}: {out[name]['seconds']:.1f} s")
            del algo
    return launches, out


# -- parallel: the mesh, sequence parallelism, a sharded step, DD-PPO ------

def par_attention(card, ops, mesh):
    """Ulysses and the ring shard function at axis size 1 at the llama-1b
    train attention shape (PAR_ATTENTION), each against reference attention
    forward and backward at the bf16 kernels' bound (BWD_TOL, TILE_TOL):
    Ulysses with 1/1/1 launches a call (fwd, dq, dkv), the ring (dense,
    fp32 statistics) with none; then Ulysses' device time (profiler) and
    wall a call (CUDA events) beside the flash kernels' own, forward and
    forward + backward.  → (launches of the checked calls, results)."""
    from ray_tpu_torch.ops.attention import reference_attention
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.ops.ring_attention import (ring_attention_shard,
                                                  ulysses_attention_shard)

    b, s, h, hk, d = PAR_ATTENTION
    dt = torch.bfloat16
    kernels = (ops.flash_fwd, ops.flash_bwd_dq, ops.flash_bwd_dkv)
    q, k, v = qkv(7, b, s, s, h, hk, d, dt)
    do = randn(8, (b, s, h, d), dt)

    def run(fn):
        ins = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = fn(*ins)
        return (o.detach(), *torch.autograd.grad(o, ins, do))

    want = run(lambda *a: reference_attention(*a, causal=True))
    on_card("parallel: reference attention")
    sides = {
        "ulysses": lambda *a: ulysses_attention_shard(
            *a, axis_name="sp", causal=True, mesh=mesh),
        "ring": lambda *a: ring_attention_shard(
            *a, axis_name="sp", axis_size=1, causal=True, mesh=mesh)}
    launches, out = {}, {}
    for name, fn in sides.items():
        for kernel in kernels:
            kernel.launches = 0
        got = run(fn)
        on_card(f"parallel: {name}")
        launches[name] = {kk.__name__: kk.launches for kk in kernels}
        errs = {}
        for what, g, w in zip(("o", "dq", "dk", "dv"), got, want):
            # the bf16 kernels' bound (2e-2 elementwise, 1e-2 a tile)
            ok, tile = bwd_matches(g, w, dt)
            errs[what] = float((g.float() - w.float()).abs().max())
            if not ok:
                raise AssertionError(
                    f"parallel: {name} {what} differs from reference "
                    f"attention by {errs[what]:.3e} (tile {tile:.3e})")
        expect = 1 if name == "ulysses" else 0
        if set(launches[name].values()) != {expect}:
            raise AssertionError(f"parallel: {name} launched "
                                 f"{launches[name]}, expected {expect} each")
        out[name] = {"max_abs_err": errs, "launches": launches[name]}
        log(f"  {name} (sp=1) against reference attention at b {b} s {s} "
            f"h {h}/{hk} d {d} bf16: max |diff| " + ", ".join(
                f"{kk} {e:.3e}" for kk, e in errs.items())
            + f"; launches {launches[name]}")
    ins = [x.detach().requires_grad_(True) for x in (q, k, v)]

    def fwd_bwd(fn):
        o = fn(*ins)
        torch.autograd.grad(o, ins, do)

    calls = {
        "ulysses_fwd": lambda: sides["ulysses"](q, k, v),
        "flash_fwd": lambda: flash_attention(q, k, v, causal=True),
        "ulysses_fwd_bwd": lambda: fwd_bwd(sides["ulysses"]),
        "flash_fwd_bwd": lambda: fwd_bwd(
            lambda *a: flash_attention(*a, causal=True))}
    # device time from the profiler; the wall a call back to back from
    # CUDA events, which grows where the host takes longer than the kernels
    out["device_ms"] = {kk: device_ms(fn) for kk, fn in calls.items()}
    out["wall_ms"] = {kk: cuda_ms(fn, 20) for kk, fn in calls.items()}
    log("  Ulysses (sp=1) against the flash kernels at that shape, device "
        "ms (profiler): " + ", ".join(f"{kk} {t:.4f}" for kk, t in
                                      out["device_ms"].items())
        + "; wall ms a call back to back (CUDA events): " + ", ".join(
            f"{kk} {t:.4f}" for kk, t in out["wall_ms"].items())
        + f" [{card}]")
    return launches["ulysses"], out


def par_train(card, ops, mesh):
    """llama-1b at the train phase's settings: the plain step and the step
    under a one-rank mesh with the weights placed by FSDP_TP_RULES as
    DTensors, from the same weights and batch.  The first loss and grad
    norm must be equal bitwise (every collective is skipped or copies at
    size 1, so the sharded step runs the plain step's products in the same
    order); the sharded steps launch fwd 32, dq 16, dkv 16 a step (two
    forwards a layer under remat "dots").  → (launches, results)."""
    from ray_tpu_torch.models import (TransformerConfig, init_params,
                                      local_leaves, make_train_step,
                                      param_leaves, params_axes)
    from ray_tpu_torch.parallel import FSDP_TP_RULES, shard_pytree, use_mesh
    from ray_tpu_torch.rl.policy import tree_map

    cfg = TransformerConfig.llama("1b", max_seq_len=TRAIN_SEQ, remat="dots",
                                  norm_remat=True, loss_chunk=128,
                                  param_dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    placed = shard_pytree(tree_map(torch.clone, params),
                          params_axes(cfg), mesh, FSDP_TP_RULES)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).to("cuda")}
    kernels = (ops.flash_fwd, ops.flash_bwd_dq, ops.flash_bwd_dkv)

    def steps(step, params, n):
        walls, first = [], None
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(params, batch)
            m = {kk: float(v) for kk, v in m.items()}     # syncs
            walls.append((time.perf_counter() - t0) * 1e3)
            first = first or m
        return first, float(np.median(walls[1:]))

    opt = torch.optim.AdamW(param_leaves(params), lr=3e-4, weight_decay=0.1)
    plain, plain_ms = steps(make_train_step(cfg, opt), params,
                            PAR_TRAIN_STEPS)
    del opt, params
    gc.collect()
    torch.cuda.empty_cache()
    opt = torch.optim.AdamW(local_leaves(placed), lr=3e-4, weight_decay=0.1)
    for kernel in kernels:
        kernel.launches = 0
    with use_mesh(mesh):
        sharded, sharded_ms = steps(make_train_step(cfg, opt), placed,
                                    PAR_TRAIN_STEPS)
    launches = {kk.__name__: kk.launches for kk in kernels}
    per_step = {name: n / PAR_TRAIN_STEPS for name, n in launches.items()}
    log(f"  llama-1b step, plain: loss {plain['loss']!r} grad_norm "
        f"{plain['grad_norm']!r}, {plain_ms:.2f} ms; under the mesh with "
        f"FSDP_TP_RULES DTensors: loss {sharded['loss']!r} grad_norm "
        f"{sharded['grad_norm']!r}, {sharded_ms:.2f} ms (medians of steps "
        f"2-{PAR_TRAIN_STEPS}); launches {per_step} a step [{card}]")
    if (sharded["loss"], sharded["grad_norm"]) != (plain["loss"],
                                                   plain["grad_norm"]):
        raise AssertionError("parallel: the sharded step's first loss or "
                             "grad norm is not the plain step's")
    # remat "dots" runs each layer's forward again in the backward
    L = cfg.n_layers
    if per_step != {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                    "flash_bwd_dkv": L}:
        raise AssertionError(f"parallel: the sharded step launched "
                             f"{per_step} a step")
    del opt, placed
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"first_loss": sharded["loss"],
                      "first_grad_norm": sharded["grad_norm"],
                      "plain_step_ms": plain_ms,
                      "sharded_step_ms": sharded_ms,
                      "launches_per_step": per_step}


def par_ddppo(card, mesh):
    """DD-PPO with one learner: one iteration (CartPole, PAR_DDPPO_PARITY)
    on the card against the CPU from the same weights, resets, draws and
    permutations, full fp32 (params within RL_PARAM_STEPS of an Adam step,
    loss parts within RL_LOSS_TOL); then at DDPPOConfig's defaults on
    CartPole a warm iteration and RL_TIMED_ITERS timed ones."""
    from ray_tpu_torch.rl import CartPole, DDPPO, DDPPOConfig
    from ray_tpu_torch.rl.policy import tree_leaves, tree_map

    sides = {dev: DDPPO(DDPPOConfig(env=CartPole, device=dev,
                                    **PAR_DDPPO_PARITY), mesh=mesh)
             for dev in ("cpu", "cuda")}
    cpu, gpu = sides["cpu"], sides["cuda"]
    gpu.params = tree_map(lambda x: x.to("cuda"), cpu.params)
    gpu.opt_state = gpu.optimizer.init(gpu.params)
    gpu.env_states = tree_map(lambda x: x.to("cuda"), cpu.env_states)
    gpu.obs = cpu.obs.to("cuda")
    gen = torch.Generator().manual_seed(1)
    n, steps = PAR_DDPPO_PARITY["num_envs"], \
        PAR_DDPPO_PARITY["rollout_length"]
    draws = [{"noise": cpu.policy.draw_noise(n, gen),
              "reset": cpu.env.reset_draws(n, gen)} for _ in range(steps)]
    perms = torch.stack([torch.randperm(n * steps, generator=gen)
                         for _ in range(cpu.config.num_sgd_epochs)])
    with fp32_ieee():
        want = cpu.training_step(draws=draws, perms=perms)
        got = gpu.training_step(draws=tree_map(lambda x: x.to("cuda"), draws),
                                perms=perms.to("cuda"))
    on_card("parallel: the DD-PPO iteration")
    parts = ("pi_loss", "vf_loss", "entropy")
    lr = cpu.config.lr
    in_steps = max(float((g.cpu() - c).abs().max()) / lr for g, c in
                   zip(tree_leaves(gpu.params), tree_leaves(cpu.params)))
    loss_err = max(abs(got[kk] - want[kk]) for kk in parts)
    log(f"  DD-PPO, 1 learner, card = CPU ({n} envs x {steps} steps, fp32): "
        f"reward_sum {got['reward_sum']} / {want['reward_sum']}, params "
        f"{in_steps:.3f} of an Adam step, loss parts {loss_err:.3e} apart "
        f"[{card}]")
    if got["reward_sum"] != want["reward_sum"]:
        raise AssertionError("parallel: DD-PPO's card rewards differ")
    if in_steps > RL_PARAM_STEPS or not all(
            np.isclose(got[kk], want[kk], rtol=RL_LOSS_TOL[0],
                       atol=RL_LOSS_TOL[1]) for kk in parts):
        raise AssertionError("parallel: DD-PPO on the card differs from the "
                             "CPU")
    algo = DDPPO(DDPPOConfig(env=CartPole, seed=0), mesh=mesh)
    algo.train()
    rates, result = [], None
    for _ in range(RL_TIMED_ITERS):
        result = algo.train()
        rates.append(result["env_steps_per_s"])
    if not np.isfinite(result["pi_loss"]):
        raise AssertionError("parallel: DD-PPO's loss is not finite")
    rate = float(np.median(rates))
    log(f"  DD-PPO at DDPPOConfig's defaults (CartPole, "
        f"{algo.config.num_envs} envs x {algo.config.rollout_length} steps, "
        f"1 learner): {rate:.0f} env-steps/s (median of {RL_TIMED_ITERS}), "
        f"episode_reward_mean {result['episode_reward_mean']:.2f} [{card}]")
    return {"card_equals_cpu": {"params_in_steps": in_steps,
                                "loss_parts": loss_err},
            "env_steps_per_s": rate}


def phase_parallel(card, ops):
    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshSpec, create_mesh
    from ray_tpu_torch.parallel.mesh import slice_topology

    log("== parallel: a one-rank NCCL mesh; Ulysses and the ring at the "
        "llama-1b train attention shape; the llama-1b step with "
        "FSDP_TP_RULES DTensors; DD-PPO with one learner")
    mesh = create_mesh(MeshSpec(), device="cuda")
    try:
        topology = slice_topology()
        log(f"  mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}, "
            f"topology {topology}")
        attn_launches, attention = par_attention(card, ops, mesh)
        train_launches, train = par_train(card, ops, mesh)
        ddppo = par_ddppo(card, mesh)
    finally:
        dist.destroy_process_group()
    launches = {name: attn_launches[name] + train_launches[name]
                for name in attn_launches}
    return launches, {"topology": topology, "attention": attention,
                      "train": train, "ddppo": ddppo}


# -- train_gang: the Train gang on the port's actor layer -------------------
# The rank functions below run in the gang's spawned processes, which find
# them by reference in this module.


def gang_model(preset, cfg_kw):
    from ray_tpu_torch.models import TransformerConfig
    if preset == "llama-1b":
        return TransformerConfig.llama("1b", **cfg_kw)
    return TransformerConfig.tiny(**cfg_kw)


def gang_llama_state(preset, cfg_kw, tokens, device):
    """The train phase's model, AdamW and batch: weights from the seed-0
    generator on ``device``."""
    from ray_tpu_torch.models import init_params, param_leaves
    cfg = gang_model(preset, cfg_kw)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    opt = torch.optim.AdamW(param_leaves(params), lr=3e-4, weight_decay=0.1)
    return cfg, params, opt, {"tokens": torch.from_numpy(tokens).to(device)}


def gang_llama_loop(config):
    """A rank of train_gang (a): ``config["steps"]`` train steps under the
    gang's mesh, reporting each step's loss, grad norm, wall ms and this
    rank's own flash launches (its counters set to 0 just before the step
    and read just after)."""
    from ray_tpu_torch import ops
    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import make_train_step
    from ray_tpu_torch.parallel import use_mesh
    started = time.time()
    device = session.get_device()
    cfg, params, opt, batch = gang_llama_state(
        config["preset"], config["cfg"], config["tokens"], device)
    kernels = (ops.flash_fwd, ops.flash_bwd_dq, ops.flash_bwd_dkv)
    with use_mesh(session.get_mesh()):
        step = make_train_step(cfg, opt)
        for i in range(config["steps"]):
            for kernel in kernels:
                kernel.launches = 0
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            m = step(params, batch)
            loss, norm = float(m["loss"]), float(m["grad_norm"])  # syncs
            ms = (time.perf_counter() - t0) * 1e3
            session.report({
                "step": i, "loss": loss, "grad_norm": norm, "step_ms": ms,
                "launches": {k.__name__: k.launches for k in kernels},
                "loop_started": started, "reported": time.time()})


def gang_llama(card, preset, cfg_kw, tokens, expected):
    """train_gang (a): GANG_STEPS steps of ``preset`` in this process, then
    through ``TorchTrainer(num_workers=1)`` with SpmdConfig on the card
    (the parent's tensors freed before the gang spawns).  The gang's first
    loss and grad norm must be bitwise the in-process step's and each
    step's launches, counted in the rank, ``expected``.  → (launches over
    the gang's steps, results)."""
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.models import make_train_step
    from ray_tpu_torch.train import SpmdConfig, TorchTrainer

    cfg, params, opt, batch = gang_llama_state(preset, cfg_kw, tokens,
                                               "cuda")
    step = make_train_step(cfg, opt)
    plain, walls = [], []
    for _ in range(GANG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(params, batch)
        plain.append((float(m["loss"]), float(m["grad_norm"])))   # syncs
        walls.append((time.perf_counter() - t0) * 1e3)
    del cfg, params, opt, batch, step, m
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    result = TorchTrainer(
        gang_llama_loop,
        train_loop_config={"preset": preset, "cfg": cfg_kw,
                           "tokens": tokens, "steps": GANG_STEPS},
        scaling_config=ScalingConfig(num_workers=1),
        backend_config=SpmdConfig(),
        run_config=RunConfig(name="llama", storage_path=GANG_DIR)).fit()
    fit_s = time.time() - t0
    if result.error is not None:
        raise AssertionError(f"train_gang: the {preset} run failed") \
            from result.error
    hist = result.metrics_history
    if [h["step"] for h in hist] != list(range(GANG_STEPS)):
        raise AssertionError(f"train_gang: reports {hist}")
    first = (hist[0]["loss"], hist[0]["grad_norm"])
    gang_ms = float(np.median([h["step_ms"] for h in hist[1:]]))
    plain_ms = float(np.median(walls[1:]))
    out = {"first_loss": first[0], "first_grad_norm": first[1],
           "plain_first": list(plain[0]), "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "gang_step_ms": gang_ms, "plain_step_ms": plain_ms,
           "launches_per_step": [h["launches"] for h in hist],
           "spawn_to_loop_s": hist[0]["loop_started"] - t0,
           "spawn_to_first_report_s": hist[0]["reported"] - t0,
           "fit_s": fit_s}
    log(f"  {preset} through TorchTrainer(num_workers=1), SpmdConfig: first "
        f"loss {first[0]!r} grad_norm {first[1]!r} (in-process "
        f"{plain[0][0]!r} / {plain[0][1]!r}); step {gang_ms:.2f} ms against "
        f"{plain_ms:.2f} in-process (medians of steps 2-{GANG_STEPS}); "
        f"launches a step {hist[0]['launches']} (counted in the rank); "
        f"fit() to the loop {out['spawn_to_loop_s']:.2f} s (spawn, import, "
        f"rendezvous), to the first report "
        f"{out['spawn_to_first_report_s']:.2f} s, whole fit {fit_s:.2f} s "
        f"[{card}]")
    if first != plain[0]:
        raise AssertionError("train_gang: the gang's first loss or grad "
                             "norm is not the in-process step's")
    if any(h["launches"] != expected for h in hist):
        raise AssertionError(f"train_gang: launches a step "
                             f"{[h['launches'] for h in hist]}, expected "
                             f"{expected}")
    if not all(np.isfinite(out["losses"])):
        raise AssertionError("train_gang: a loss is not finite")
    launches = {name: sum(h["launches"][name] for h in hist)
                for name in expected}
    return launches, out


def gang_tiny_state(tokens, device):
    """The tiny fp32 model of tests/test_train.py:47-76 on ``device`` with
    optax.adamw(1e-3)'s hyperparameters: weights from the seed-0
    generator."""
    from ray_tpu_torch.models import init_params, param_leaves
    cfg = gang_model("tiny", GANG_TINY)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    opt = torch.optim.AdamW(param_leaves(params), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    return cfg, params, opt, {"tokens": torch.from_numpy(tokens).to(device)}


def gang_restart_loop(config):
    """A rank of train_gang (b): GANG_TINY_STEPS steps, each reported with
    a checkpoint of the weights and the optimizer state; resumes from the
    session's checkpoint; rank 0 raises once at step GANG_FAIL_AT (a
    marker file remembers it did)."""
    from ray_tpu_torch.air import Checkpoint, session
    from ray_tpu_torch.models import make_train_step, param_leaves
    from ray_tpu_torch.rl.policy import tree_map
    cfg, params, opt, batch = gang_tiny_state(config["tokens"],
                                              session.get_device())
    start, ck = 0, session.get_checkpoint()
    if ck is not None:
        state = ck.to_dict()
        with torch.no_grad():
            for leaf, saved in zip(param_leaves(params), state["params"]):
                leaf.copy_(saved)
        opt.load_state_dict(state["opt"])
        start = state["step"] + 1
    step = make_train_step(cfg, opt)
    for i in range(start, GANG_TINY_STEPS):
        if i == GANG_FAIL_AT and session.get_world_rank() == 0 \
                and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            raise RuntimeError(f"injected failure at step {i}")
        loss = float(step(params, batch)["loss"])
        opt_state = tree_map(lambda x: x.cpu() if isinstance(
            x, torch.Tensor) else x, opt.state_dict())
        state = {"step": i, "opt": opt_state,
                 "params": [p.detach().cpu() for p in param_leaves(params)]}
        session.report({"step": i, "loss": loss, "reported": time.time()},
                       checkpoint=Checkpoint.from_dict(state))


def gang_restart(card, tokens):
    """train_gang (b): the restart loop through TorchTrainer with
    FailureConfig(max_failures=1) on the card.  No error in the Result;
    steps 0, 1, then 2, 3 resumed from the step-1 checkpoint; every loss
    bitwise an uninterrupted in-process run's (at worst within 1e-6
    relative, said so)."""
    from ray_tpu_torch.air import FailureConfig, RunConfig, ScalingConfig
    from ray_tpu_torch.models import make_train_step
    from ray_tpu_torch.train import TorchTrainer

    cfg, params, opt, batch = gang_tiny_state(tokens, "cuda")
    step = make_train_step(cfg, opt)
    want = [float(step(params, batch)["loss"])
            for _ in range(GANG_TINY_STEPS)]
    marker = os.path.join(GANG_DIR, "failed_once")
    t0 = time.time()
    result = TorchTrainer(
        gang_restart_loop,
        train_loop_config={"tokens": tokens, "marker": marker},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="restart", storage_path=GANG_DIR,
                             failure_config=FailureConfig(max_failures=1))
    ).fit()
    done = time.time()
    hist = result.metrics_history
    got = [h["loss"] for h in hist]
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    # from fit() to the first report, from the failed attempt's last
    # report to the second attempt's first, from the last report to the
    # return of fit (the gang's teardown)
    times = {"to_first_report_s": hist[0]["reported"] - t0,
             "restart_s": hist[GANG_FAIL_AT]["reported"]
             - hist[GANG_FAIL_AT - 1]["reported"],
             "teardown_s": done - hist[-1]["reported"], "fit_s": done - t0}
    log(f"  restart: error {result.error!r}, steps "
        f"{[h['step'] for h in hist]}, losses {got} against an "
        f"uninterrupted run's {want} (max relative {rel:.3e}); seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
        + f" [{card}]")
    if result.error is not None or not os.path.exists(marker):
        raise AssertionError("train_gang: the restart did not run as "
                             "planned") from result.error
    if [h["step"] for h in result.metrics_history] != [0, 1, 2, 3]:
        raise AssertionError("train_gang: the restart did not resume from "
                             "the step-1 checkpoint")
    if got != want:
        if rel > 1e-6:
            raise AssertionError("train_gang: the resumed losses differ from "
                                 "the uninterrupted run's")
        log("  restart: not bitwise, within 1e-6 relative")
    return {"losses": got, "uninterrupted": want, "bitwise": got == want,
            "max_rel": rel, **times}


def gang_until_killed(config):
    """A rank of train_gang (c): tiny steps, each reported; writes its pid
    to ``config["pid_file"]`` after the first; ends by itself after
    ``config["steps"]`` steps if nobody kills it."""
    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import make_train_step
    cfg, params, opt, batch = gang_tiny_state(config["tokens"],
                                              session.get_device())
    step = make_train_step(cfg, opt)
    for i in range(config["steps"]):
        loss = float(step(params, batch)["loss"])
        session.report({"step": i, "loss": loss})
        if i == 0:
            with open(config["pid_file"] + ".tmp", "w") as f:
                f.write(str(os.getpid()))
            os.rename(config["pid_file"] + ".tmp", config["pid_file"])
        time.sleep(0.01)


def gang_killed_rank(card, tokens):
    """train_gang (c): SIGKILL the rank a second after its first report;
    fit must return a Result whose error is a TrainingFailedError naming
    rank 0 and exit code -9 within GANG_KILL_BOUND_S."""
    import signal

    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.train import TorchTrainer, TrainingFailedError

    pid_file = os.path.join(GANG_DIR, "rank.pid")
    killed = {}

    def killer():
        deadline = time.monotonic() + 300
        while not os.path.exists(pid_file):
            if time.monotonic() > deadline:
                return
            time.sleep(0.05)
        time.sleep(1.0)
        with open(pid_file) as f:
            killed["pid"] = int(f.read())
        killed["at"] = time.monotonic()
        os.kill(killed["pid"], signal.SIGKILL)

    thread = threading.Thread(target=killer, daemon=True)
    thread.start()
    result = TorchTrainer(
        gang_until_killed,
        train_loop_config={"tokens": tokens, "pid_file": pid_file,
                           "steps": 3000},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="killed", storage_path=GANG_DIR)).fit()
    returned = time.monotonic()
    thread.join(5)
    if "at" not in killed:
        raise AssertionError("train_gang: the rank never wrote its pid")
    after = returned - killed["at"]
    log(f"  killed rank: SIGKILL to pid {killed['pid']} after "
        f"{len(result.metrics_history)} reports; fit returned "
        f"{after:.3f} s later with {result.error!r} [{card}]")
    want = f"rank 0 (pid {killed['pid']}) died with exit code " \
        f"{-signal.SIGKILL}"
    if not (isinstance(result.error, TrainingFailedError)
            and want in str(result.error)):
        raise AssertionError(f"train_gang: the killed rank gave "
                             f"{result.error!r}, not {want!r}")
    if after > GANG_KILL_BOUND_S:
        raise AssertionError("train_gang: the kill was noticed late")
    return {"error": str(result.error), "reports": len(result.metrics_history),
            "noticed_after_s": after}


def tree_bytes(tree):
    """Bytes of the tensors of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() \
        if isinstance(tree, torch.Tensor) else 0


def gang_resume_loop(config):
    """A rank of train_gang (d): (a)'s steps, with params and the AdamW
    state saved once with Checkpoint.from_pytree after step
    GANG_RESUME_AT - 1 and reported; rank 0 fails once at GANG_RESUME_AT
    (a marker file remembers it did); a restarted rank restores the
    registered save with to_pytree onto its card and runs the rest.  Each
    step reports its loss, grad norm and this rank's flash launches; the
    save and the restore their seconds and bytes."""
    import shutil

    from ray_tpu_torch import ops
    from ray_tpu_torch.air import Checkpoint, session
    from ray_tpu_torch.models import make_train_step, param_leaves
    from ray_tpu_torch.parallel import use_mesh
    device = session.get_device()
    cfg, params, opt, batch = gang_llama_state(
        config["preset"], config["cfg"], config["tokens"], device)
    kernels = (ops.flash_fwd, ops.flash_bwd_dq, ops.flash_bwd_dkv)
    start, restore, ck = 0, None, session.get_checkpoint()
    if ck is not None:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state = ck.to_pytree(device=device)
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        with torch.no_grad():
            for leaf, saved in zip(param_leaves(params),
                                   param_leaves(state["params"])):
                leaf.copy_(saved)
        for moments in state["opt"]["state"].values():
            # AdamW keeps its step count on the host
            moments["step"] = moments["step"].cpu()
        opt.load_state_dict(state["opt"])
        start = state["step"] + 1
        nbytes = tree_bytes(state)
        restore = {"seconds": seconds, "bytes": nbytes,
                   "gb_per_s": nbytes / seconds / 1e9, "from": ck.path}
        del state
    with use_mesh(session.get_mesh()):
        step = make_train_step(cfg, opt)
        for i in range(start, config["steps"]):
            if i == GANG_RESUME_AT and session.get_world_rank() == 0 \
                    and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError(f"injected failure at step {i}")
            for kernel in kernels:
                kernel.launches = 0
            m = step(params, batch)
            loss, norm = float(m["loss"]), float(m["grad_norm"])  # syncs
            report = {"step": i, "loss": loss, "grad_norm": norm,
                      "launches": {k.__name__: k.launches for k in kernels},
                      "restore": restore if i == start else None}
            ck = None
            if i == GANG_RESUME_AT - 1:
                tree = {"params": params, "opt": opt.state_dict(), "step": i}
                nbytes = tree_bytes(tree)
                os.makedirs(config["path"], exist_ok=True)
                disk = shutil.disk_usage(config["path"])
                if disk.free < GANG_DISK_FACTOR * nbytes:
                    raise RuntimeError(
                        f"not enough disk for the save: {disk.free} bytes "
                        f"free under {config['path']}, the save and its "
                        f"registered copy need {2 * nbytes}")
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                ck = Checkpoint.from_pytree(tree, path=config["path"])
                seconds = time.perf_counter() - t0
                report["save"] = {
                    "seconds": seconds, "bytes": nbytes,
                    "gb_per_s": nbytes / seconds / 1e9,
                    "disk_before": {"total": disk.total, "used": disk.used,
                                    "free": disk.free}}
            session.report(report, checkpoint=ck)


def gang_resume(card, preset, cfg_kw, tokens, expected, uninterrupted):
    """train_gang (d): ``preset`` saved sharded after step 1 in a one-rank
    SpmdConfig gang, failed at step 2 and resumed from the save with
    FailureConfig(max_failures=1).  The resumed steps' losses and grad
    norms must be bitwise (a)'s uninterrupted steps' (``uninterrupted``:
    (losses, grad norms)); each step's launches ``expected``, counted in
    the rank.  The manager's register (its copy of the save into the run
    directory) is timed here, where the trainer runs it.  → (launches,
    results)."""
    from ray_tpu_torch.air import FailureConfig, RunConfig, ScalingConfig
    from ray_tpu_torch.train import SpmdConfig, TorchTrainer, checkpointing

    register = checkpointing.CheckpointManager.register
    registered = []

    def timed_register(self, iteration, checkpoint, metrics=None):
        t0 = time.perf_counter()
        path = register(self, iteration, checkpoint, metrics)
        registered.append({"iteration": iteration,
                           "seconds": time.perf_counter() - t0})
        return path

    checkpointing.CheckpointManager.register = timed_register
    try:
        t0 = time.time()
        result = TorchTrainer(
            gang_resume_loop,
            train_loop_config={
                "preset": preset, "cfg": cfg_kw, "tokens": tokens,
                "steps": GANG_STEPS,
                "path": os.path.join(GANG_DIR, "resume_saves"),
                "marker": os.path.join(GANG_DIR, "resume_failed_once")},
            scaling_config=ScalingConfig(num_workers=1),
            backend_config=SpmdConfig(),
            run_config=RunConfig(
                name="resume", storage_path=GANG_DIR,
                failure_config=FailureConfig(max_failures=1))).fit()
        fit_s = time.time() - t0
    finally:
        checkpointing.CheckpointManager.register = register
    if result.error is not None:
        raise AssertionError(f"train_gang (d): the {preset} run failed") \
            from result.error
    hist = result.metrics_history
    if [h["step"] for h in hist] != list(range(GANG_STEPS)):
        raise AssertionError(f"train_gang (d): steps {hist}")
    save = hist[GANG_RESUME_AT - 1]["save"]
    restore = hist[GANG_RESUME_AT]["restore"]
    got = [(h["loss"], h["grad_norm"]) for h in hist]
    want = list(zip(*uninterrupted))
    gaps = [max(abs(g[0] - w[0]), abs(g[1] - w[1]))
            for g, w in zip(got, want)]
    out = {"losses": [g[0] for g in got], "grad_norms": [g[1] for g in got],
           "uninterrupted_losses": [w[0] for w in want],
           "uninterrupted_grad_norms": [w[1] for w in want],
           "bitwise": got == want, "largest_gap": max(gaps),
           "launches_per_step": [h["launches"] for h in hist],
           "save": save, "register": registered, "restore": restore,
           "fit_s": fit_s}
    log(f"  (d) {preset} resumed from a sharded save: steps 0-{GANG_STEPS - 1}"
        f" losses {out['losses']} grad norms {out['grad_norms']} against "
        f"(a)'s {out['uninterrupted_losses']} / "
        f"{out['uninterrupted_grad_norms']}: bitwise {out['bitwise']}, "
        f"largest gap {out['largest_gap']!r}; launches a step "
        f"{hist[0]['launches']} (counted in the rank) [{card}]")
    log(f"  (d) disk before the save {save['disk_before']}; the rank's "
        f"save {save['bytes']} bytes in {save['seconds']:.2f} s "
        f"({save['gb_per_s']:.2f} GB/s); the manager's register (copy) "
        + ", ".join(f"iteration {r['iteration']} {r['seconds']:.2f} s"
                    for r in registered)
        + f"; the restore {restore['bytes']} bytes in "
        f"{restore['seconds']:.2f} s ({restore['gb_per_s']:.2f} GB/s); "
        f"whole fit {fit_s:.2f} s [{card}]")
    if got[GANG_RESUME_AT:] != want[GANG_RESUME_AT:GANG_STEPS]:
        raise AssertionError(
            f"train_gang (d): the resumed steps are not (a)'s bitwise: "
            f"largest gap {max(gaps[GANG_RESUME_AT:])!r}")
    if got != want:
        raise AssertionError("train_gang (d): the steps before the save "
                             f"are not (a)'s: gaps {gaps}")
    if any(h["launches"] != expected for h in hist):
        raise AssertionError(f"train_gang (d): launches a step "
                             f"{out['launches_per_step']}, expected "
                             f"{expected}")
    launches = {name: sum(h["launches"][name] for h in hist)
                for name in expected}
    return launches, out


def phase_train_gang(card, ops):
    import concurrent.futures
    import importlib.util
    import multiprocessing
    import shutil

    log("== train_gang: llama-1b through TorchTrainer (a one-rank NCCL "
        "gang); then side by side, each its own gang, a restart from a "
        "checkpoint and a killed rank; no process left")
    cloudpickle = importlib.util.find_spec("cloudpickle") is not None
    log(f"  cloudpickle installed: {cloudpickle}")
    shutil.rmtree(GANG_DIR, ignore_errors=True)
    os.makedirs(GANG_DIR)
    try:
        cfg = gang_model("llama-1b", GANG_LLAMA)
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
        L = cfg.n_layers
        expected = {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                    "flash_bwd_dkv": L}
        launches, llama = gang_llama(card, "llama-1b", GANG_LLAMA, tokens,
                                     expected)
        resumed_launches, resumed = gang_resume(
            card, "llama-1b", GANG_LLAMA, tokens, expected,
            (llama["losses"], llama["grad_norms"]))
        launches = {k: v + resumed_launches[k] for k, v in launches.items()}
        tiny = np.random.default_rng(1).integers(0, 256, (2, 32))
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            restart = pool.submit(gang_restart, card, tiny)
            killed = pool.submit(gang_killed_rank, card, tiny)
            restart, killed = restart.result(), killed.result()
    finally:
        shutil.rmtree(GANG_DIR, ignore_errors=True)
    left = multiprocessing.active_children()
    log(f"  processes left: {left}")
    if left:
        raise AssertionError("train_gang: a gang left a process")
    return launches, {"cloudpickle": cloudpickle, "llama": llama,
                      "restart": restart, "killed_rank": killed,
                      "resumed": resumed}


# -- host_dp: ViT-B/16 trained host data-parallel ----------------------------
# As the train_gang ranks, host_dp_loop runs in a spawned rank process that
# finds it by reference in this module.


def host_dp_state(device):
    """The vit phase's model, batch and AdamW on ``device``: weights from
    the seed-0 generator, the batch from the seed-1 one."""
    from ray_tpu_torch.models import ViTConfig, init_vit_params, param_leaves
    cfg = ViTConfig.base()
    params = init_vit_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    gen = torch.Generator(device=device).manual_seed(1)
    shape = (cfg.image_size, cfg.image_size, cfg.channels)
    batch = {"image": torch.randn((VIT_TRAIN_BATCH, *shape), generator=gen,
                                  device=device),
             "label": torch.randint(0, cfg.num_classes, (VIT_TRAIN_BATCH,),
                                    generator=gen, device=device)}
    opt = torch.optim.AdamW(param_leaves(params), lr=3e-4, weight_decay=0.1)
    return cfg, params, opt, batch


def host_dp_steps(device, steps):
    """``steps`` host data-parallel steps of ViT-B/16 on ``device``: the
    loss's forward and backward on the card (the train step's own helpers),
    the gradients through ``host_collective.allreduce_pytree(..., "mean")``
    (the trainer's store in a HostArrayConfig rank; in a process with no
    gang, the flatten and its float32 round trip alone), written back, one
    AdamW step.  → per step: loss, the flash launches and the wall split
    into card work and the reduce (ms, synced)."""
    from ray_tpu_torch import ops
    from ray_tpu_torch.models import param_leaves, vit_loss
    from ray_tpu_torch.models.transformer import _apply_grads, _loss_and_grads
    from ray_tpu_torch.train import host_collective
    cfg, params, opt, batch = host_dp_state(device)
    leaves = param_leaves(params)
    kernels = (ops.flash_fwd, ops.flash_bwd_dq, ops.flash_bwd_dkv)
    out = []
    for _ in range(steps):
        for kernel in kernels:
            kernel.launches = 0
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        loss, _, grads = _loss_and_grads(
            lambda p: vit_loss(p, batch, cfg), params, leaves)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        grads = host_collective.allreduce_pytree(list(grads), "mean")
        torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        _apply_grads(opt, leaves, grads)
        loss = float(loss)                                        # syncs
        t3 = time.perf_counter()
        out.append({"loss": loss,
                    "launches": {k.__name__: k.launches for k in kernels},
                    "card_ms": ((t1 - t0) + (t3 - t2)) * 1e3,
                    "reduce_ms": (t2 - t1) * 1e3,
                    "step_ms": (t3 - t0) * 1e3,
                    "reduce_bytes": 4 * sum(g.numel() for g in grads)})
    return out


def host_dp_loop(config):
    """A rank of the host_dp phase: host_dp_steps on its card, each step
    reported with the bytes the store held at once for its reduce."""
    from ray_tpu_torch.air import session
    from ray_tpu_torch.train import host_collective
    t0 = time.time()
    for i, step in enumerate(host_dp_steps(session.get_device(),
                                           config["steps"])):
        session.report({"step": i, **step,
                        "store_held_bytes":
                            host_collective.peak_held_bytes(),
                        "world": host_collective._STORE[2],
                        "loop_started": t0})


def phase_host_dp(card, ops):
    """ViT-B/16 at batch 64 trained host data-parallel: HOST_DP_STEPS steps
    in this process with no gang, then through TorchTrainer(num_workers=1,
    backend_config=HostArrayConfig()) (no process group; the gradients
    through the trainer's TCPStore).  The gang's losses must be bitwise the
    in-process loop's (a mean over one rank is the value itself, and the
    float32 round trip of each fp32 leaf is exact); 12/12/12 launches a
    step, counted in the rank."""
    import multiprocessing
    import shutil

    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.models import ViTConfig
    from ray_tpu_torch.train import HostArrayConfig, TorchTrainer

    log("== host_dp: ViT-B/16, batch 64, trained host data-parallel "
        "(gradients through host_collective) in this process, then through "
        "TorchTrainer(num_workers=1) with HostArrayConfig")
    L = ViTConfig.base().n_layers
    expected = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    plain = host_dp_steps("cuda", HOST_DP_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    run_dir = os.path.join(GANG_DIR, "host_dp")
    t0 = time.time()
    try:
        result = TorchTrainer(
            host_dp_loop, train_loop_config={"steps": HOST_DP_STEPS},
            scaling_config=ScalingConfig(num_workers=1),
            backend_config=HostArrayConfig(),
            run_config=RunConfig(name="host_dp", storage_path=run_dir)).fit()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    fit_s = time.time() - t0
    if result.error is not None:
        raise AssertionError("host_dp: the gang failed") from result.error
    hist = result.metrics_history
    med = {key: float(np.median([h[key] for h in hist[1:]]))
           for key in ("step_ms", "card_ms", "reduce_ms")}
    plain_med = {key: float(np.median([p[key] for p in plain[1:]]))
                 for key in ("step_ms", "card_ms", "reduce_ms")}
    nbytes = hist[0]["reduce_bytes"]
    out = {"losses": [h["loss"] for h in hist],
           "plain_losses": [p["loss"] for p in plain],
           "bitwise": [h["loss"] for h in hist] == [p["loss"] for p in plain],
           "gang": med, "in_process": plain_med,
           "reduce_share": med["reduce_ms"] / med["step_ms"],
           "reduce_bytes": nbytes,
           "reduce_gb_per_s": nbytes / (med["reduce_ms"] / 1e3) / 1e9,
           "store_held_bytes_max": max(h["store_held_bytes"] for h in hist),
           "launches_per_step": [h["launches"] for h in hist],
           "spawn_to_loop_s": hist[0]["loop_started"] - t0, "fit_s": fit_s}
    log(f"  losses {out['losses']} against the in-process loop's "
        f"{out['plain_losses']}: bitwise {out['bitwise']}; launches a step "
        f"{hist[0]['launches']} (counted in the rank) [{card}]")
    log(f"  a step (medians of steps 2-{HOST_DP_STEPS}): {med['step_ms']:.2f}"
        f" ms, card {med['card_ms']:.2f} ms, host reduce "
        f"{med['reduce_ms']:.2f} ms ({100 * out['reduce_share']:.1f}% of the "
        f"step) of {nbytes} bytes ({out['reduce_gb_per_s']:.3f} GB/s); in "
        f"process with no gang {plain_med['step_ms']:.2f} ms, card "
        f"{plain_med['card_ms']:.2f}, the reduce's flatten and round trip "
        f"{plain_med['reduce_ms']:.2f}; the TCPStore held at most "
        f"{out['store_held_bytes_max']} bytes; fit() to the loop "
        f"{out['spawn_to_loop_s']:.2f} s, whole fit {fit_s:.2f} s [{card}]")
    left = multiprocessing.active_children()
    if left:
        raise AssertionError(f"host_dp: a gang left a process: {left}")
    if not out["bitwise"]:
        raise AssertionError("host_dp: the gang's losses are not the "
                             "in-process loop's bitwise")
    if any(h["launches"] != expected for h in hist) or any(
            p["launches"] != expected for p in plain):
        raise AssertionError(f"host_dp: launches a step "
                             f"{out['launches_per_step']}, expected "
                             f"{expected}")
    if hist[0]["world"] != 1 or not all(np.isfinite(out["losses"])):
        raise AssertionError("host_dp: the gang's losses are not finite")
    launches = {name: sum(h["launches"][name] for h in hist)
                for name in expected}
    return launches, out


# -- serve_gang: llama-1b served by a gang replica ---------------------------
# The callables live in tests/torch_serve_gang_models.py (torch and the port
# only), which the member process imports by reference.


def serve_gang_requests(ask, fwd_tokens, gen_payload):
    """One warm forward and generate, then SERVE_GANG_REQUESTS of each
    through ``ask(payload, method)``: → (replies by method, the warm ones
    first, and the host wall ms of each timed one)."""
    out = {"forward": [ask(fwd_tokens, "forward")],
           "generate": [ask(gen_payload, "generate")]}
    walls = {"forward": [], "generate": []}
    for method, payload in (("forward", fwd_tokens),
                            ("generate", gen_payload)):
        for _ in range(SERVE_GANG_REQUESTS):
            t0 = time.perf_counter()
            out[method].append(ask(payload, method))
            walls[method].append((time.perf_counter() - t0) * 1e3)
    return out, walls


def phase_serve_gang(card, ops):
    """llama-1b at full width (bf16 weights from seed 0, flash attention)
    served in this process on plain weights, then by a one-member NCCL gang
    replica (``serve.gang.start_gang_replica``) whose member places the same
    weights under FSDP_TP_RULES over its mesh: every forward summary (shape,
    mean, the bit-pattern checksum, the last position's argmax) and every
    generated token bitwise the in-process ones; 16 flash_fwd launches and
    no backward launch a request, counted in the member.  Then the leader
    SIGKILLed with a generate in flight: that request fails with
    ActorDiedError, a later one with ReplicaUnavailableError, and
    stop_gang_replica leaves no process."""
    import multiprocessing
    import signal

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_serve_gang_models as models
    from ray_tpu_torch.core import actors
    from ray_tpu_torch.exceptions import (ActorDiedError,
                                          ReplicaUnavailableError)
    from ray_tpu_torch.serve import gang

    log("== serve_gang: llama-1b in a one-member NCCL gang replica "
        "(weights placed under FSDP_TP_RULES) against the same requests "
        "in this process; then the leader killed mid-request")
    cfg_kw = dict(param_dtype=torch.bfloat16, attention_impl="flash")
    cfg = models.model_config("llama-1b", cfg_kw)
    rng = np.random.default_rng(0)
    fwd_tokens = rng.integers(0, cfg.vocab_size, SERVE_GANG_FORWARD)
    b, s, n = SERVE_GANG_GENERATE
    gen_payload = {"prompt": rng.integers(0, cfg.vocab_size, (b, s)), "n": n}
    expected = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0}

    params = models.plain_params(cfg, 0, "cuda")
    plain, plain_walls = serve_gang_requests(
        lambda payload, method: getattr(models, f"{method}_request")(
            params, cfg, payload, torch.device("cuda")),
        fwd_tokens, gen_payload)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    entry = {"callable_blob": actors.dumps_function(models.ShardedModel),
             "init_args": ("llama-1b", cfg_kw, 0), "init_kwargs": {}}
    t0 = time.perf_counter()
    rep = gang.start_gang_replica("llama-1b", "serve-gang-0", entry,
                                  {"gang_size": 1, "gang_mesh": "tp=1"})
    ready_s = time.perf_counter() - t0
    handle = rep["handle"]
    try:
        served, walls = serve_gang_requests(
            lambda payload, method: actors.get(
                handle.handle_request.remote((payload,), {}, method), 300),
            fwd_tokens, gen_payload)
        peak_gib = actors.get(handle.handle_request.remote(
            (), {}, "peak_memory_gib"), 60)
        # the death path: a generate in flight when the leader dies
        inflight = handle.handle_request.remote((gen_payload,), {},
                                                "generate")
        time.sleep(0.05)
        leader = rep["gang"][0]
        os.kill(leader.pid, signal.SIGKILL)
        killed = time.perf_counter()
        try:
            actors.get(inflight, SERVE_GANG_KILL_BOUND_S)
            died = None
        except ActorDiedError as e:
            died = e
        noticed_s = time.perf_counter() - killed
        try:
            actors.get(handle.handle_request.remote((fwd_tokens,), {},
                                                    "forward"), 30)
            later = None
        except ReplicaUnavailableError as e:
            later = e
    finally:
        gang.stop_gang_replica(rep)
    left = multiprocessing.active_children()

    def med(xs):
        return float(np.median(xs))

    out = {"ready_s": ready_s, "peak_member_gib": peak_gib,
           "forward_ms": {"gang": med(walls["forward"]),
                          "in_process": med(plain_walls["forward"]),
                          "member": med([r["member_ms"]
                                         for r in served["forward"][1:]])},
           "generate_ms_per_token": {
               "gang": med(walls["generate"]) / n,
               "in_process": med(plain_walls["generate"]) / n,
               "member": med([r["member_ms"]
                              for r in served["generate"][1:]]) / n},
           "forward_summary": {k: served["forward"][0][k] for k in (
               "shape", "mean", "checksum", "argmax_last")},
           "generated": served["generate"][0]["tokens"],
           "launches_per_request": {
               method: [r["launches"] for r in served[method]]
               for method in served},
           "killed_leader": {"error": repr(died),
                             "noticed_after_s": noticed_s,
                             "later": repr(later)},
           "processes_left": [p.pid for p in left]}
    log(f"  start_gang_replica to ready {ready_s:.2f} s (spawn, imports, "
        f"NCCL group, llama-1b placed); peak member memory "
        f"{peak_gib:.2f} GiB [{card}]")
    log(f"  forward 1 x {SERVE_GANG_FORWARD[1]}: "
        f"{out['forward_ms']['gang']:.2f} ms through the gang, "
        f"{out['forward_ms']['member']:.2f} in the member, "
        f"{out['forward_ms']['in_process']:.2f} in process; generate B {b}, "
        f"{s}-token prompt, {n} new: "
        f"{out['generate_ms_per_token']['gang']:.3f} ms/token through the "
        f"gang, {out['generate_ms_per_token']['member']:.3f} in the member, "
        f"{out['generate_ms_per_token']['in_process']:.3f} in process "
        f"(medians of {SERVE_GANG_REQUESTS}) [{card}]")
    log(f"  forward summary {out['forward_summary']}; generated "
        f"{out['generated']}; launches a request "
        f"{served['forward'][0]['launches']} (counted in the member)")
    log(f"  leader SIGKILLed 0.05 s into a generate: {died!r} after "
        f"{noticed_s:.3f} s; the next request {later!r}; processes left "
        f"{out['processes_left']} [{card}]")
    keys = ("shape", "mean", "checksum", "argmax_last")
    want = {k: plain["forward"][0][k] for k in keys}
    if any({k: r[k] for k in keys} != want
           for r in plain["forward"] + served["forward"]):
        raise AssertionError("serve_gang: a forward summary is not the "
                             "in-process one bitwise")
    tokens = plain["generate"][0]["tokens"]
    if any(r["tokens"] != tokens
           for r in plain["generate"] + served["generate"]):
        raise AssertionError("serve_gang: generated tokens differ from the "
                             "in-process ones")
    if np.asarray(tokens).shape != (b, n) or not np.isfinite(
            out["forward_summary"]["mean"]) or out["forward_summary"][
            "shape"] != [*SERVE_GANG_FORWARD, cfg.vocab_size]:
        raise AssertionError(f"serve_gang: shapes {out['forward_summary']}")
    if any(r["rank"] != 0 or r["launches"] != expected
           for method in served for r in served[method]) or any(
            r["launches"] != expected
            for method in plain for r in plain[method]):
        raise AssertionError(f"serve_gang: launches a request "
                             f"{out['launches_per_request']}, expected "
                             f"{expected}")
    if died is None or died.exitcode != -signal.SIGKILL \
            or noticed_s > SERVE_GANG_KILL_BOUND_S or later is None:
        raise AssertionError("serve_gang: the leader's death was not "
                             "reported as it should be")
    if left:
        raise AssertionError(f"serve_gang: a process is left: {left}")
    # every request through the gang, the warm ones included
    launches = {name: sum(r["launches"][name] for method in served
                          for r in served[method]) for name in expected}
    return launches, out


def top_kernels(by_name, n):
    """The ``n`` kernels with the most device time, then the port's own
    (flash_*) kernels that are not among them."""
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return ranked[:n] + [kv for kv in ranked[n:] if "flash_" in kv[0]]


def device_kernel_ms(fn):
    """Device time (ms) by kernel name for one call of ``fn``, from
    torch.profiler; empty where it recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        # a user annotation (record_function, e.g. Optimizer.step) mirrored
        # on the device timeline spans kernels counted on their own
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    return by_name


def host_ops(fn):
    """(PyTorch ops the host issued, kernels the card ran) for one call of
    ``fn``, from torch.profiler: top-level CPU ops (views included) and
    CUDA kernel events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    ops = sum(1 for e in events if e.device_type == DeviceType.CPU
              and e.cpu_parent is None)
    kernels = sum(1 for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    return ops, kernels


def hopper_instance(function):
    """'flash_bwd_dkv_hopper_kernel<64, 128>',
    'flash_bwd_dq_fp32_kernel<128, 16>' or 'flash_fwd_fp32_kernel<64, 64,
    true>' from a mangled name; None for any other kernel."""
    found = re.search(r"(flash_[a-z_]+_hopper_kernel|flash_(?:fwd|bwd_d[a-z]+)"
                      r"_fp32_kernel)I(.*?)EEv", function)
    if not found:
        return None
    args = [("true" if value == "1" else "false") if kind == "b" else value
            for kind, value in re.findall(r"L([ib])(\d+)E", found[2])]
    return f"{found[1]}<{', '.join(args)}>"


def check_ptxas(nvcc_log):
    """Fail on what ptxas says would cost a Hopper kernel its overlap: a
    wgmma serialised, or a spill in any instance of a *_hopper_kernel
    (forward, dQ, dK/dV) or of the fp32 route's register-blocked kernels
    (forward, dQ, dK/dV); print each instance's registers."""
    if "wgmma.mma_async instructions are serialized" in nvcc_log:
        raise AssertionError("ptxas serialised wgmma instructions")
    name = None
    for line in nvcc_log.splitlines():
        if "Function properties for" in line:
            name = hopper_instance(line.split()[-1])
        elif name:
            if "spill stores" in line and not line.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill stores"):
                raise AssertionError(f"ptxas spilled in {name}: {line}")
            if "Used" in line and "registers" in line:
                log(f"  ptxas: {name}: {line.split(':', 1)[1].strip()}")


def phase_build(build):
    log("== build")
    for built in build.build_all():
        log(f"  {built.name}: {built.path.name} in {built.seconds:.2f} s")
        log(built.log.rstrip())
        check_ptxas(built.log)


# --compare-fwd / --compare-bwd: the fp32 kernels of each given source,
# held against the plain versions at these cases, then timed at these
# shapes of CASES (forward) and BWD_CASES (backward)
COMPARE_CASES = [("s17", 1, 17, 17, 4, 2, 64, True),
                 ("dt", 64, 60, 60, 1, 1, 128, True),
                 ("dt-eval", 1, 60, 60, 1, 1, 128, True),
                 ("s_q>s_kv", 1, 300, 100, 4, 2, 128, True),
                 ("non-causal", 1, 384, 300, 4, 2, 128, False),
                 ("fp32", 1, 1024, 1024, 32, 8, 64, True),
                 ("b*h 768", 64, 128, 128, 12, 4, 64, True),
                 ("s_q<s_kv", 1, 256, 1000, 8, 2, 64, True)]
COMPARE_FWD_TIMED = ("dt", "dt-eval", "fp32")
COMPARE_BWD_TIMED = ("dt", "fp32")


def compare_sources(card, build, sources, entries, check, timings):
    """A/B of the fp32 kernels of several sources (another checkout's
    csrc/<name>.cu, built with its own headers, or this tree's): nvcc all
    at once, each fp32 instance's registers and spills; ``check(i, lib,
    case)`` for each source at each of COMPARE_CASES, which raises where
    a source disagrees with the plain version; then, for each (label,
    kernel name, bound, library ms or None, ``fn_of(lib)``) of
    ``timings()``, each source's device time in turns (first source to
    last, then back) beside the bound.  ``entries`` maps each C entry
    point to its count of pointer arguments."""
    import ctypes

    out = build.BUILD_DIR / "compare"
    out.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"lib{i}.so"),
         src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, src in enumerate(sources)]
    libs = []
    for i, (src, proc) in enumerate(zip(sources, procs)):
        nvcc_log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{nvcc_log}")
        name = None
        for line in nvcc_log.splitlines():
            if "Function properties for" in line:
                name = hopper_instance(line.split()[-1])
                name = name if name and "fp32" in name else None
            elif name and "spill stores" in line:
                spills = line.strip()
            elif name and "Used" in line:
                log(f"  [{i}] {name}: {line.split(':', 1)[1].strip()}; "
                    f"{spills}")
        lib = ctypes.CDLL(str(out / f"lib{i}.so"))
        for entry, n_ptr in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        libs.append(lib)
        log(f"  [{i}] {src}")
    for case in COMPARE_CASES:
        for i, lib in enumerate(libs):
            check(i, lib, case)
        log(f"  {case[0]}: every source agrees with the plain version")
    for label, kname, bound, library_ms, fn_of in timings():
        times = {}
        order = list(range(len(libs)))
        for i in order + order[::-1]:
            fn = fn_of(libs[i])
            times.setdefault(i, []).append(device_ms(
                fn, kernel_name(kname, torch.float32), calls=20))
        lib_text = ("" if library_ms is None else
                    f"; scaled_dot_product_attention {library_ms:.4f}")
        log(f"  {label} {kname} (bound {bound:.4f} ms{lib_text}) device ms: "
            + "; ".join(f"[{i}] {min(t):.4f}-{max(t):.4f} "
                        f"({100 * bound / min(t):.1f}%)"
                        for i, t in times.items()) + f" [{card}]")
    return 0


def fp32_call(lib, entry, ins, outs, q, k, causal, scale):
    """``entry`` of a compared library on fp32 tensors → ``outs``."""
    b, s_q, h, d = q.shape
    err = getattr(lib, entry)(
        *[t.data_ptr() for t in (*ins, *outs)], 1, b, h, k.shape[2], s_q,
        k.shape[1], d, int(causal), scale, q.device.index,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry}: {err}")
    return outs


def compare_fwd(card, ops, build, sources):
    """A/B of the fp32 forward kernel of several flash_fwd.cu sources:
    O and LSE against flash_attention_plain at COMPARE_CASES, then device
    time at COMPARE_FWD_TIMED beside the bound and SDPA's forward."""
    fp32 = torch.float32

    def forward(lib, q, k, v, causal, scale):
        lse = torch.empty(q.shape[0], q.shape[2], q.shape[1], dtype=fp32,
                          device=q.device)
        return fp32_call(lib, "ray_tpu_flash_fwd", (q, k, v),
                         (torch.empty_like(q), lse), q, k, causal, scale)

    def check(i, lib, case):
        name, b, s_q, s_kv, h, h_kv, d, causal = case
        q, k, v = qkv(0, b, s_q, s_kv, h, h_kv, d, fp32)
        scale = d ** -0.5
        o, lse = forward(lib, q, k, v, causal, scale)
        on_card(f"source {i}, case {name}")
        o_ref, lse_ref = ops.flash_attention_plain(q, k, v, causal, scale)
        if not fwd_matches(o, lse, o_ref, lse_ref, fp32)[0]:
            raise AssertionError(f"source {i} disagrees with the plain "
                                 f"version in case {name}")

    def timings():
        for shape in COMPARE_FWD_TIMED:
            _, b, s_q, s_kv, h, h_kv, d, dtype, causal = named(CASES, shape)
            q, k, v = qkv(1, b, s_q, s_kv, h, h_kv, d, fp32)
            scale = d ** -0.5
            bound, _ = attention_bound(b, s_q, s_kv, h, h_kv, d, dtype,
                                       causal)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            library_ms = device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale,
                    enable_gqa=True), calls=20)
            yield (shape, "flash_fwd", bound, library_ms,
                   lambda lib: lambda: forward(lib, q, k, v, causal, scale))

    return compare_sources(card, build, sources, {"ray_tpu_flash_fwd": 5},
                           check, timings)


def compare_bwd(card, ops, build, sources):
    """A/B of the fp32 backward kernels of several flash_bwd.cu sources:
    dQ, dK and dV against the plain versions at COMPARE_CASES, then each
    kernel's device time at COMPARE_BWD_TIMED beside its bound."""
    fp32 = torch.float32

    def kernels(lib):
        return (lambda q, k, v, *rest: fp32_call(
                    lib, "ray_tpu_flash_bwd_dq", (q, k, v, *rest[:3]),
                    (torch.empty_like(q),), q, k, *rest[3:]),
                lambda q, k, v, *rest: fp32_call(
                    lib, "ray_tpu_flash_bwd_dkv", (q, k, v, *rest[:3]),
                    (torch.empty_like(k), torch.empty_like(v)), q, k,
                    *rest[3:]))

    def inputs(q_seed, do_seed, b, s_q, s_kv, h, h_kv, d, causal):
        q, k, v = qkv(q_seed, b, s_q, s_kv, h, h_kv, d, fp32)
        do = randn(do_seed, (b, s_q, h, d), fp32)
        scale = d ** -0.5
        o, lse = ops.flash_fwd(q, k, v, causal, scale)
        return (q, k, v, do, lse, delta_of(o, do), causal, scale), o

    def check(i, lib, case):
        name, b, s_q, s_kv, h, h_kv, d, causal = case
        args, o = inputs(2, 3, b, s_q, s_kv, h, h_kv, d, causal)
        q, k, v, do, lse, _, _, scale = args
        want = ops.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                             scale)
        dq, dkv = kernels(lib)
        got = (*dq(*args), *dkv(*args))
        on_card(f"source {i}, case {name}")
        if not all(bwd_matches(g, w, fp32)[0] for g, w in zip(got, want)):
            raise AssertionError(f"source {i} disagrees with the plain "
                                 f"version in case {name}")

    def timings():
        for shape in COMPARE_BWD_TIMED:
            _, b, s_q, s_kv, h, h_kv, d, dtype, causal = named(BWD_CASES,
                                                               shape)
            args, _ = inputs(5, 6, b, s_q, s_kv, h, h_kv, d, causal)
            for which, kname, counts in (
                    (0, "flash_bwd_dq", dict(products=3, q_like=3, kv_like=2,
                                             stats=2)),
                    (1, "flash_bwd_dkv", dict(products=4, q_like=2,
                                              kv_like=4, stats=2))):
                bound, _ = attention_bound(b, s_q, s_kv, h, h_kv, d, dtype,
                                           causal, **counts)
                yield (shape, kname, bound, None,
                       lambda lib, which=which: functools.partial(
                           kernels(lib)[which], *args))

    return compare_sources(card, build, sources, {"ray_tpu_flash_bwd_dq": 7,
                                                  "ray_tpu_flash_bwd_dkv": 8},
                           check, timings)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch import ops
    from ray_tpu_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"== card: {card}")
    log(f"   torch {torch.__version__}, CUDA {torch.version.cuda}")
    if sys.argv[1:2] == ["--compare-fwd"]:
        return compare_fwd(card, ops, build, sys.argv[2:])
    if sys.argv[1:2] == ["--compare-bwd"]:
        return compare_bwd(card, ops, build, sys.argv[2:])

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0
        log(f"  phase {name}: {seconds[name]:.1f} s")
        return result

    timed("build", phase_build, build)
    rows = [timed("kernels", phase_kernels, card, ops),
            *timed("bwd_kernels", phase_bwd_kernels, card, ops)]
    by_path = {"serve": {"flash_fwd": timed("slice", phase_slice, card,
                                            ops.flash_fwd)}}
    by_path["engine"], engine = timed("engine", phase_engine, card, ops)
    by_path["train"] = timed("train", phase_train, card, ops)
    moe_paths, moe = timed("moe", phase_moe, card, ops)
    vit_paths, vit = timed("vit", phase_vit, card, ops)
    by_path["rl"], rl = timed("rl", phase_rl, card, ops)
    by_path["offpolicy"], offpolicy = timed("offpolicy", phase_offpolicy,
                                            card, ops)
    by_path["rl_breadth"], rl_breadth = timed("rl_breadth",
                                              phase_rl_breadth, card, ops)
    by_path["rl_rest"], rl_rest = timed("rl_rest", phase_rl_rest, card, ops)
    by_path["parallel"], parallel = timed("parallel", phase_parallel, card,
                                          ops)
    by_path["train_gang"], train_gang = timed("train_gang", phase_train_gang,
                                              card, ops)
    by_path["host_dp"], host_dp = timed("host_dp", phase_host_dp, card, ops)
    by_path["serve_gang"], serve_gang = timed("serve_gang", phase_serve_gang,
                                              card, ops)
    by_path.update(moe_paths)
    by_path.update(vit_paths)
    log(f"  phase seconds: {json.dumps(seconds)}")
    for row in rows:
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in by_path.items()
                                   if row["name"] in counts}
        row["launches"] = sum(row["launches_by_path"].values())
    log(card)
    print(json.dumps({"engine": engine}))
    print(json.dumps({"moe": moe, "vit": vit, "seconds": seconds}))
    print(json.dumps({"rl": rl, "seconds": seconds["rl"]}))
    print(json.dumps({"offpolicy": offpolicy,
                      "seconds": seconds["offpolicy"]}))
    print(json.dumps({"rl_breadth": rl_breadth,
                      "seconds": seconds["rl_breadth"]}))
    print(json.dumps({"rl_rest": rl_rest, "seconds": seconds["rl_rest"]}))
    print(json.dumps({"parallel": parallel, "seconds": seconds["parallel"]}))
    print(json.dumps({"train_gang": train_gang,
                      "seconds": seconds["train_gang"]}))
    print(json.dumps({"host_dp": host_dp, "seconds": seconds["host_dp"]}))
    print(json.dumps({"serve_gang": serve_gang,
                      "seconds": seconds["serve_gang"]}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
