"""AlphaZero: self-play MCTS and policy / value network training
(counterpart of ``ray_tpu/rl/alpha_zero.py``).

The JAX package keeps the search tree as fixed-size arrays (node-indexed
visit counts, values, priors and a children map; the public mctx design),
walks it with a ``lax.while_loop`` per simulation and ``vmap``s whole games.
Here the same array tree holds every game at once, ``[G, nodes, ...]``:
each simulation's selection is ``max_depth`` fixed iterations over all
games under a per-game ``done`` mask (a game that has reached its leaf
stops changing), so nothing branches on the device; the expansion writes
the new node where the leaf is not terminal; the backup adds along the
path with one ``index_put_(accumulate=True)``: a path's (node, action)
edges are distinct, so each receives one addition, the value the JAX
package's loop gives it.  ``argmax`` takes the first of tied maxima in
both packages.

The draws (the Dirichlet root noise of every search and the Gumbel noise of
the temperature sampling and of the random opponent) come from the
algorithm's `torch.Generator` or as an argument; the epochs' permutations
likewise.  Training is the AlphaZero loss: cross-entropy of the network's
policy against the MCTS visit distribution plus the value head's squared
error against the game's outcome, with optax's Adam (`ppo.Adam`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..device import DeviceLike, resolve_device
from .algorithm import Algorithm
from .learner import value_and_grad
from .policy import (gumbel, mlp_apply, mlp_init, tree_from_numpy,
                     tree_map, tree_to_numpy)
from .ppo import Adam

State = Dict[str, torch.Tensor]


class TicTacToe:
    """3x3 alternating-move games, batched.  Board: [n, 9] values in {-1,
    0, +1} from the CURRENT player's perspective (+1 = mine); after every
    move the board flips sign so the network always sees the position to
    move."""

    num_actions = 9
    observation_size = 9
    max_game_len = 9

    _LINES = ((0, 1, 2), (3, 4, 5), (6, 7, 8), (0, 3, 6), (1, 4, 7),
              (2, 5, 8), (0, 4, 8), (2, 4, 6))

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._lines = torch.tensor(self._LINES, device=self.device)

    def initial_state(self, n: int) -> State:
        dev = self.device
        return {"board": torch.zeros((n, 9), dtype=torch.int8, device=dev),
                "terminal": torch.zeros(n, dtype=torch.bool, device=dev),
                # outcome for the player who JUST moved (+1 win / 0)
                "winner": torch.zeros(n, device=dev)}

    def legal_mask(self, state: State) -> torch.Tensor:
        return (state["board"] == 0) & ~state["terminal"][..., None]

    def step(self, state: State, action: torch.Tensor) -> State:
        """Apply each game's current player's move ``action`` [n] → the
        states FLIPPED to the next player's perspective.  ``winner`` is +1
        where the move just played won the game, else 0; draws end with
        winner 0."""
        board = state["board"].scatter(-1, action[..., None].long(), 1)
        won = (board[..., self._lines] == 1).all(-1).any(-1)
        full = (board != 0).all(-1)
        return {"board": -board,
                "terminal": won | full | state["terminal"],
                "winner": won.float()}


def _where_state(cond: torch.Tensor, a: State, b: State) -> State:
    """Per game, ``a`` where ``cond`` and ``b`` elsewhere."""
    return {k: torch.where(cond.view((-1,) + (1,) * (a[k].dim() - 1)),
                           a[k], b[k]) for k in a}


def dirichlet(alpha: float, shape, gen: torch.Generator) -> torch.Tensor:
    """Symmetric Dirichlet draws over the last axis of ``shape``."""
    g = torch._standard_gamma(torch.full(shape, float(alpha),
                                         device=gen.device), generator=gen)
    return g / g.sum(-1, keepdim=True)


@dataclasses.dataclass
class AlphaZeroConfig:
    # game factory, called as env(device=...); None = TicTacToe
    env: Optional[Callable[..., Any]] = None
    num_simulations: int = 32      # MCTS simulations per move
    c_puct: float = 1.5
    dirichlet_alpha: float = 0.6   # root exploration noise
    dirichlet_eps: float = 0.25
    temperature_moves: int = 2     # sample-by-visits for the first k moves
    games_per_iter: int = 64       # self-play games per training_step
    epochs_per_iter: int = 2
    batch_size: int = 256
    lr: float = 3e-3
    value_coeff: float = 1.0
    hidden: tuple = (64, 64)
    seed: int = 0
    # where the games, the search and the update run (None: the card)
    device: Any = None

    def build(self) -> "AlphaZero":
        return AlphaZero(self)


def make_mcts(game, net_apply, num_simulations: int, c_puct: float):
    """→ ``mcts(params, root_state, noise, noise_eps) -> (visit
    distribution [G, A], root value [G], tree)`` over G games at once.
    ``noise`` [G, A] is the Dirichlet root noise, mixed in with weight
    ``noise_eps``.

    The array tree: node 0 is the root, each simulation adds at most one
    node.  ``tree`` holds the game states of the nodes and ``P``, ``N``,
    ``W`` [G, nodes, A] (prior, visit count, total value of each edge,
    from the perspective of the player moving on it: negamax) and
    ``children`` [G, nodes, A] (node index or -1)."""
    A = game.num_actions
    max_nodes = num_simulations + 1
    max_depth = game.max_game_len + 1

    def eval_net(params, state):
        logits, value = net_apply(params, state["board"].float())
        logits = torch.where(game.legal_mask(state), logits, -1e9)
        # terminal nodes have no network value: the game outcome rules
        # (the state is post-move, flipped: winner = 1 means the player to
        # move here has LOST)
        value = torch.where(state["terminal"], -state["winner"], value)
        return torch.softmax(logits, -1), value

    def mcts(params, root_state: State, noise: torch.Tensor,
             noise_eps: float):
        G = root_state["board"].shape[0]
        dev = root_state["board"].device
        gi = torch.arange(G, device=dev)
        nodes = {k: v.new_zeros((G, max_nodes) + v.shape[1:])
                 for k, v in root_state.items()}
        for k, v in root_state.items():
            nodes[k][:, 0] = v
        P = torch.zeros((G, max_nodes, A), device=dev)
        N = torch.zeros((G, max_nodes, A), device=dev)
        W = torch.zeros((G, max_nodes, A), device=dev)
        children = torch.full((G, max_nodes, A), -1, dtype=torch.long,
                              device=dev)

        prior0, _ = eval_net(params, root_state)
        prior0 = torch.where(game.legal_mask(root_state),
                             (1 - noise_eps) * prior0 + noise_eps * noise,
                             0.0)
        P[:, 0] = prior0 / torch.clamp(prior0.sum(-1, keepdim=True),
                                       min=1e-9)
        ply = torch.arange(max_depth, device=dev)

        def at(node):
            return {k: v[gi, node] for k, v in nodes.items()}

        for sim in range(num_simulations):
            # -- selection: walk PUCT until an unexpanded child, every
            # game at once; a game that stopped keeps its node and depth
            node = torch.zeros(G, dtype=torch.long, device=dev)
            depth = torch.zeros(G, dtype=torch.long, device=dev)
            path_n = torch.full((G, max_depth), -1, dtype=torch.long,
                                device=dev)
            path_a = torch.full_like(path_n, -1)
            done = torch.zeros(G, dtype=torch.bool, device=dev)
            for _ in range(max_depth):
                live = ~done
                n_node, w_node, p_node = N[gi, node], W[gi, node], \
                    P[gi, node]
                n_tot = n_node.sum(-1, keepdim=True)
                q = w_node / torch.clamp(n_node, min=1.0)
                u = c_puct * p_node * torch.sqrt(n_tot + 1.0) \
                    / (1.0 + n_node)
                state_n = at(node)
                score = torch.where(game.legal_mask(state_n), q + u,
                                    -torch.inf)
                act = torch.argmax(score, -1)
                slot = depth.clamp(max=max_depth - 1)[:, None]
                path_n.scatter_(1, slot, torch.where(
                    live, node, path_n.gather(1, slot)[:, 0])[:, None])
                path_a.scatter_(1, slot, torch.where(
                    live, act, path_a.gather(1, slot)[:, 0])[:, None])
                child = children[gi, node, act]
                # a terminal node stops HERE (it has no legal move)
                stop = state_n["terminal"] | (child < 0)
                node = torch.where(live & (child >= 0), child, node)
                depth = depth + live.long()
                done = done | stop
            # leaf = the last visited node; edge = (leaf, act)
            last = (depth - 1)[:, None]
            leaf = path_n.gather(1, last)[:, 0]
            act = path_a.gather(1, last)[:, 0]
            leaf_state = at(leaf)
            is_term = leaf_state["terminal"]

            # -- expansion and evaluation
            child_state = game.step(leaf_state, act.clamp(min=0))
            prior_c, value_c = eval_net(params, child_state)
            # a terminal leaf: its outcome is the value
            value = torch.where(is_term, -leaf_state["winner"], value_c)
            expand = ~is_term
            new = sim + 1
            for k, v in nodes.items():
                v[:, new] = torch.where(
                    expand.view((-1,) + (1,) * (v.dim() - 2)),
                    child_state[k], v[:, new])
            P[:, new] = torch.where(expand[:, None], prior_c, P[:, new])
            children[gi, leaf, act] = torch.where(
                expand, new, children[gi, leaf, act])

            # -- backup along the path (negamax: the value flips sign per
            # ply; `value` is from the perspective of the player to move
            # AT THE EVALUATED position, at ply `depth` for a new child,
            # at `depth - 1` for a terminal leaf, whose placeholder edge
            # is not updated).  The edges are distinct: one index_put_.
            eval_ply = torch.where(is_term, depth - 1, depth)
            on_path = ply[None] < eval_ply[:, None]
            sign = torch.where((eval_ply[:, None] - ply[None]) % 2 == 1,
                               -value[:, None], value[:, None])
            index = (gi[:, None].expand(-1, max_depth),
                     path_n.clamp(min=0), path_a.clamp(min=0))
            N.index_put_(index, on_path.float(), accumulate=True)
            W.index_put_(index, torch.where(on_path, sign, 0.0),
                         accumulate=True)
        visits = N[:, 0]
        total = torch.clamp(visits.sum(-1), min=1e-9)
        tree = {"state": nodes, "P": P, "N": N, "W": W,
                "children": children}
        return visits / total[:, None], W[:, 0].sum(-1) / total, tree

    return mcts


class AlphaZero(Algorithm):
    _config_cls = AlphaZeroConfig

    def __init__(self, config: AlphaZeroConfig):
        super().__init__(config)
        cfg = config
        self.device = resolve_device(cfg.device)
        self.game = (cfg.env or TicTacToe)(device=self.device)
        if cfg.games_per_iter * self.game.max_game_len < cfg.batch_size:
            raise ValueError(
                f"games_per_iter={cfg.games_per_iter} x max_game_len="
                f"{self.game.max_game_len} yields fewer rows than "
                f"batch_size={cfg.batch_size}: every epoch would run "
                f"zero minibatches and train nothing")
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        h = tuple(cfg.hidden)
        self.params = {k: mlp_init(self.generator, s) for k, s in (
            ("torso", (self.game.observation_size,) + h),
            ("pi", (h[-1], self.game.num_actions)), ("v", (h[-1], 1)))}
        self.optimizer = Adam(cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._mcts = make_mcts(self.game, self._net, cfg.num_simulations,
                               cfg.c_puct)

    def param_shapes(self):
        """``{torso, pi, v}`` (`convert.policy_params_from_numpy`)."""
        return tree_map(lambda x: tuple(x.shape), self.params)

    # -- network ------------------------------------------------------------
    @staticmethod
    def _net(params, board):
        x = board
        for layer in params["torso"]:
            x = torch.tanh(x @ layer["w"] + layer["b"])
        logits = mlp_apply(params["pi"], x)
        value = torch.tanh(mlp_apply(params["v"], x)[..., 0])
        return logits, value

    # -- self-play ----------------------------------------------------------
    def selfplay_draws(self, n_games: Optional[int] = None) -> List[Dict]:
        """Per move ``{"dirichlet": [G, A], "gumbel": [G, A]}``: the root
        noise of the move's search and the temperature sampling's
        noise."""
        cfg, gen = self.config, self.generator
        G = n_games or cfg.games_per_iter
        A = self.game.num_actions
        return [{"dirichlet": dirichlet(cfg.dirichlet_alpha, (G, A), gen),
                 "gumbel": gumbel((G, A), gen)}
                for _ in range(self.game.max_game_len)]

    @torch.no_grad()
    def selfplay(self, draws: Optional[List[Dict]] = None
                 ) -> Dict[str, torch.Tensor]:
        """``games_per_iter`` games at once, MCTS at every move for both
        players → ``{"board", "pi", "z", "live"}`` of shape [G, T, ...]."""
        cfg, game = self.config, self.game
        if draws is None:
            draws = self.selfplay_draws()
        G = draws[0]["dirichlet"].shape[0]
        state = game.initial_state(G)
        win_ply = torch.full((G,), -1, dtype=torch.long, device=self.device)
        frames = {"board": [], "pi": [], "live": []}
        for t, d in enumerate(draws):
            pi, _, _ = self._mcts(self.params, state, d["dirichlet"],
                                  cfg.dirichlet_eps)
            # temperature: sample by visits early, argmax later
            if t < cfg.temperature_moves:
                action = torch.argmax(
                    torch.log(torch.clamp(pi, min=1e-9)) + d["gumbel"], -1)
            else:
                action = torch.argmax(pi, -1)
            frames["board"].append(state["board"].float())
            frames["pi"].append(pi)
            frames["live"].append(~state["terminal"])
            nxt = game.step(state, action)
            # the move that ended the game with a win: its MOVER won
            just_won = nxt["terminal"] & ~state["terminal"] \
                & (nxt["winner"] > 0)
            win_ply = torch.where(just_won, t, win_ply)
            state = _where_state(state["terminal"], state, nxt)
        out = {k: torch.stack(v, 1) for k, v in frames.items()}
        # value target per ply: +1 for the winner's parity, -1 for the
        # loser's, 0 for draws
        ply = torch.arange(len(draws), device=self.device)
        out["z"] = torch.where(
            win_ply[:, None] < 0, 0.0,
            torch.where(ply[None] % 2 == win_ply[:, None] % 2, 1.0, -1.0))
        return out

    # -- training -----------------------------------------------------------
    def loss(self, params, batch):
        logits, value = self._net(params, batch["board"])
        logp = torch.log_softmax(logits, -1)
        ce = -(batch["pi"] * logp).sum(-1)
        mse = (value - batch["z"]) ** 2
        w = batch["live"].float()
        denom = torch.clamp(w.sum(), min=1.0)
        return ((ce + self.config.value_coeff * mse) * w).sum() / denom, \
            (ce * w).sum() / denom

    def learn(self, games: Dict[str, torch.Tensor], perms=None):
        """``epochs_per_iter`` epochs of minibatches over the games' rows →
        the last epoch's mean (loss, policy cross-entropy), tensors.
        ``perms``: a permutation of the rows per epoch (tests)."""
        cfg = self.config
        data = {k: v.reshape((-1,) + v.shape[2:]) for k, v in games.items()}
        n = data["board"].shape[0]
        n_mb = n // cfg.batch_size
        for e in range(cfg.epochs_per_iter):
            idx = (perms[e] if perms is not None else torch.randperm(
                n, generator=self.generator, device=self.device))
            losses, ces = [], []
            for i in range(n_mb):
                sel = idx[i * cfg.batch_size:(i + 1) * cfg.batch_size]
                loss, ce, grads = value_and_grad(
                    self.loss, self.params, {k: v[sel] for k, v in
                                             data.items()})
                self.optimizer.update(grads, self.opt_state, self.params)
                losses.append(loss)
                ces.append(ce)
        return torch.stack(losses).mean(), torch.stack(ces).mean()

    def training_step(self, draws=None) -> Dict[str, Any]:
        """``draws``: ``{"selfplay": [...], "perms": [...]}`` (tests), else
        the generator."""
        cfg = self.config
        t0 = time.perf_counter()
        games = self.selfplay(None if draws is None else draws["selfplay"])
        loss, ce = self.learn(games, None if draws is None
                              else draws["perms"])
        # the iteration's one read of the device
        loss, ce = torch.stack([loss, ce]).tolist()
        live = games["live"].cpu().numpy()
        z = games["z"].cpu().numpy()
        dt = time.perf_counter() - t0
        first = z[:, 0]                   # outcome from player-1 plies
        return {
            "total_loss": loss,
            "policy_ce": ce,
            "games": cfg.games_per_iter,
            "p1_win_rate": float((first > 0).mean()),
            "draw_rate": float((z.max(axis=1) == 0).mean()),
            "moves_per_game": float(live.sum(axis=1).mean()),
            "env_steps_this_iter": int(live.sum()),
            "env_steps_per_s": float(live.sum() / dt),
        }

    # -- evaluation ---------------------------------------------------------
    @torch.no_grad()
    def play_vs_random(self, n_games: int = 32, az_first: bool = True,
                       draws: Optional[List[Dict]] = None
                       ) -> Dict[str, float]:
        """Pit greedy-MCTS AlphaZero against a uniform-random player, all
        games at once.  ``az_first``: AlphaZero always opens; otherwise
        sides alternate game to game.  ``draws``: `selfplay_draws`'s
        layout, the search's root noise (weighted 0) and the random
        player's Gumbel noise."""
        game = self.game
        if draws is None:
            draws = self.selfplay_draws(n_games)
        state = game.initial_state(n_games)
        plays_even = (torch.ones(n_games, dtype=torch.bool,
                                 device=self.device) if az_first else
                      torch.arange(n_games, device=self.device) % 2 == 0)
        az_w = torch.zeros(n_games, dtype=torch.bool, device=self.device)
        rnd_w = torch.zeros_like(az_w)
        for t, d in enumerate(draws):
            pi, _, _ = self._mcts(self.params, state, d["dirichlet"], 0.0)
            az_act = torch.argmax(pi, -1)
            rand_act = torch.argmax(torch.where(
                game.legal_mask(state), 0.0, -1e9) + d["gumbel"], -1)
            az_turn = (t % 2 == 0) == plays_even
            nxt = game.step(state, torch.where(az_turn, az_act, rand_act))
            just_won = nxt["terminal"] & ~state["terminal"] \
                & (nxt["winner"] > 0)
            az_w |= just_won & az_turn
            rnd_w |= just_won & ~az_turn
            state = _where_state(state["terminal"], state, nxt)
        az_wins, rnd_wins = torch.stack([az_w.sum(), rnd_w.sum()]).tolist()
        return {"az_win_rate": az_wins / n_games,
                "random_win_rate": rnd_wins / n_games,
                "draw_rate": 1.0 - (az_wins + rnd_wins) / n_games}

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {"params": tree_to_numpy(self.params),
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = tree_from_numpy(state["params"], self.device)
        self.iteration = state.get("iteration", 0)
