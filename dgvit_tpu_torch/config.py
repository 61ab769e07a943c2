"""The ported subset of the typed configuration.

A copy of what the port reads from the JAX package's config: the model
architecture and compute dtype, the SAC hyperparameters of the plain
update and its replay buffer, the env loop's limits and command scaling,
and the training loop's thresholds, intervals and paths, with the same
names, defaults and validation. Unknown keys raise, as there.

`load_reference_yaml` translates the reference's flat config.yaml into a
`Config`, key for key as the JAX package's translator does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _update_dataclass(obj, data: Dict[str, Any], path: str = ""):
    names = {f.name for f in dataclasses.fields(obj)}
    for key, val in data.items():
        if key not in names:
            raise KeyError(f"unknown config key {path + key!r}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            _update_dataclass(cur, val, path=path + key + ".")
            continue
        # coerce scalars to the default's type so a YAML string such as
        # '1.0e9' fails here rather than deep inside the model
        if isinstance(cur, bool):
            if not isinstance(val, bool):
                raise TypeError(f"config key {path + key!r}: expected bool, "
                                f"got {type(val).__name__} {val!r}")
        elif isinstance(cur, (int, float)) and not isinstance(val, bool):
            try:
                val = type(cur)(val)
            except (TypeError, ValueError):
                raise TypeError(
                    f"config key {path + key!r}: expected "
                    f"{type(cur).__name__}, got {type(val).__name__} "
                    f"{val!r}") from None
        setattr(obj, key, val)
    return obj


@dataclass
class ModelConfig:
    """Actor, critic and trunk. Defaults are the flagship actor: the GoT
    at dim 64, 4 blocks of 4 heads x 64, MLP 2048, (128, 160) depth frames
    cut into 16x20 patches. `backbone` 'simple_vit' puts the Transformer
    actors and critic on SimpleViT (`vit_dim`, `vit_depth`, `vit_heads`,
    `dim_head`, MLP `mlp_dim`); the CNN actors and critic have fixed
    widths."""

    name: str = "gtrl"
    # GaussianTransformer | GaussianConvNet | DeterministicTransformer |
    # Deterministic
    actor_type: str = "GaussianTransformer"
    critic_type: str = "Transformer"  # Transformer | CNN
    backbone: str = "got"   # got | simple_vit
    block: int = 4          # transformer depth
    head: int = 4           # attention heads
    dim_head: int = 64
    mlp_dim: int = 2048
    latent_size: int = 64   # token width
    image_size: Tuple[int, int] = (128, 160)
    patch_size: Tuple[int, int] = (16, 20)
    emb_dropout: float = 0.1
    # block dropout: a key of the JAX config that, there as here, the
    # factories do not hand on to the networks
    dropout: float = 0.0
    patch_mode: str = "2d"  # 2d (single frame) | channels (frame stack)
    compute_dtype: str = "float32"  # float32 | bfloat16
    # the token stream sharded over a `seq` mesh axis (ring attention):
    # not ported, refused by name
    seq_shard: bool = False
    # the SimpleViT family's widths (the reference fixes 256 / 2 / 8)
    vit_dim: int = 256
    vit_depth: int = 2
    vit_heads: int = 8

    def validate(self):
        ih, iw = self.image_size
        ph, pw = self.patch_size
        if ih % ph or iw % pw:
            raise ValueError(f"image {self.image_size} must divide into "
                             f"patches {self.patch_size}")
        if self.actor_type not in ACTOR_TYPES:
            raise ValueError(f"actor_type {self.actor_type!r}")
        if self.critic_type not in CRITIC_TYPES:
            raise ValueError(f"critic_type {self.critic_type!r}")
        if self.backbone not in ("got", "simple_vit"):
            raise ValueError(f"backbone {self.backbone!r}")
        if self.patch_mode not in ("2d", "channels"):
            raise ValueError(f"patch_mode {self.patch_mode!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        if self.seq_shard:
            raise NotImplementedError(
                "model.seq_shard (ring attention over a seq mesh axis) is "
                "not ported")


ACTOR_TYPES = ("GaussianTransformer", "GaussianConvNet",
               "DeterministicTransformer", "Deterministic")
CRITIC_TYPES = ("Transformer", "CNN")


@dataclass
class SACConfig:
    """SAC hyperparameters of the plain update (the JAX package's
    config.py:98-216, reference DRL.py:34-39)."""

    action_dim: int = 2
    pstate_dim: int = 2      # polar goal (distance, heading)
    gamma: float = 0.999
    tau: float = 0.0005
    lr_actor: float = 1e-3
    lr_critic: float = 1e-3
    lr_alpha: float = 1e-4
    alpha: float = 1.0       # initial (auto-tuned) or fixed temperature
    auto_tune_alpha: bool = True
    policy_freq: int = 1     # soft-update cadence
    batch_size: int = 32
    buffer_size: int = 30000
    guidence_weight: float = 1.0   # expert BC loss weight
    engage_weight: float = 1.0     # intervention loss weight
    # guidance-weight curriculum: geometric decay from guidence_weight to
    # guidence_weight_final over guidence_decay_steps learn steps (None/0:
    # constant)
    guidence_weight_final: Optional[float] = None
    guidence_decay_steps: int = 0
    # True samples by priority and feeds |TD error| back (`learn_per`, or
    # `learn_guidence_per` with an expert buffer): the host loops through
    # the C++ buffer's sum-tree, the on-device loop through
    # replay/device_per.py
    prioritized_replay: bool = False
    # True overlaps replay sampling and the copy to the card with the
    # update through a background BatchPrefetcher (replay/staging.py);
    # batches are up to two steps stale, so opt-in
    prefetch_batches: bool = False
    # True evaluates the actor loss on the critic update's own trunk
    # latent and the heads' pre-update parameters, skipping the actor
    # step's critic trunk (one K4 an update; the JAX package's opt-in,
    # off the reference's ordering, DRL.py:401-407). GoT critic only
    critic_latent_reuse: bool = False
    # True adds the (1 - done) mask the reference's TD target omits
    done_mask_in_target: bool = False
    # True rolls back an update whose losses are not finite (the step
    # counter still advances)
    nan_guard: bool = False
    # clamps of the auto-tuned temperature after each alpha update
    alpha_max: Optional[float] = None
    alpha_min: Optional[float] = None
    # DrQ-v2 random shift at update time (ops/augment.py): each sampled
    # obs and next_obs (and the expert frames of the guided update) is
    # replicate-padded by this many pixels and cropped back at a random
    # per-sample offset; 0 trains on the raw replayed frames
    aug_shift: int = 0
    # False: the shifted frames feed only the TD target and the critic
    # loss, the actor step sees the raw frames (DrQ-v2's routing)
    aug_actor: bool = True
    # the first aug_warmup updates see the raw frames
    aug_warmup: int = 0

    def validate(self):
        if self.action_dim < 1 or self.pstate_dim < 1:
            raise ValueError("action_dim and pstate_dim must be positive")
        if self.aug_shift < 0 or self.aug_warmup < 0:
            raise ValueError("aug_shift and aug_warmup must be >= 0")
        if (self.aug_warmup or not self.aug_actor) and self.aug_shift <= 0:
            raise ValueError(
                "aug_warmup/aug_actor only shape the DrQ shift augmentation;"
                " they are silently inert without sac.aug_shift > 0")
        if not 0.0 < self.gamma <= 1.0:
            raise ValueError(f"gamma {self.gamma} outside (0, 1]")
        if not 0.0 < self.tau <= 1.0:
            raise ValueError(f"tau {self.tau} outside (0, 1]")
        if self.alpha_max is not None:
            if self.alpha_max <= 0.0:
                raise ValueError("alpha_max must be > 0")
            if not self.auto_tune_alpha and self.alpha > self.alpha_max:
                raise ValueError(
                    "alpha_max only clamps the auto-tuned temperature; with "
                    "auto_tune_alpha=False set alpha <= alpha_max directly")
        if self.alpha_min is not None:
            if self.alpha_min <= 0.0:
                raise ValueError("alpha_min must be > 0")
            if self.alpha_max is not None and self.alpha_min > self.alpha_max:
                raise ValueError("alpha_min > alpha_max")
            if not self.auto_tune_alpha and self.alpha < self.alpha_min:
                raise ValueError(
                    "alpha_min only clamps the auto-tuned temperature; with "
                    "auto_tune_alpha=False set alpha >= alpha_min directly")
        if self.alpha <= 0.0:
            raise ValueError("sac.alpha must be > 0 (it seeds log_alpha)")


@dataclass
class EnvConfig:
    """Environment loop knobs (reference: env_lab.py:170-301,
    config.yaml:43-48)."""

    vis_sensor: str = "depth_image"   # image | fish_image | depth_image
    max_steps: int = 800
    max_episodes: int = 800
    linear_cmd_scale: float = 0.25    # L_SCALE
    angular_cmd_scale: float = 1.0    # A_SCALE
    max_action: float = 1.0
    # reward constants of the live simulator's adapter
    # (envs/ros2_adapter.py; env_lab.py:275-301)
    r_target: float = 200.0
    r_collision: float = -100.0
    heuristic_scale: float = 20.0
    goal_radius: float = 0.5
    collision_range: float = 0.2
    dist_norm: float = 15.0           # distance clip/normalizer (env_lab.py:296)
    reward_clip: Tuple[float, float] = (-200.0, 500.0)
    frame_stack: int = 4              # channels count in patch_mode 'channels'
    # True stacks the last `frame_stack` frames online (model.patch_mode
    # must be 'channels'); the reference records such demos but never
    # enables the live stack
    use_frame_stack: bool = False

    def validate(self):
        if self.vis_sensor not in ("image", "fish_image", "depth_image"):
            raise ValueError(f"vis_sensor {self.vis_sensor!r}")


@dataclass
class TrainConfig:
    """The training loop's knobs (reference: config.yaml, main.py)."""

    seed: int = 3407
    desc: str = "98"
    plot_interval: int = 10
    eval_threshold: int = 80
    eval_epoch: int = 5
    save_interval: int = 50
    save_threshold: float = 1.0
    reward_threshold: float = 90.0
    save: bool = True
    # snapshot the replay transitions beside each periodic checkpoint, so a
    # resumed run starts with a warm buffer (a full-size buffer is ~10 GB)
    save_replay: bool = False
    pre_train: bool = True
    if_test: bool = False
    pre_buffer: bool = True
    human_intervention: bool = False
    # head-only fine-tuning (P_ATTENTION_FIX / C_ATTENTION_FIX): the
    # Transformer actors' or critic's `trans` and `fc_embed` stay frozen
    policy_attention_fix: bool = False
    critic_attention_fix: bool = False
    checkpoint_dir: str = "checkpoints"
    data_dir: str = "data"
    robot: str = "scout"          # ROBOT
    # base paths without the _actor/_critic.npz suffix; empty = skip
    pre_train_model: str = ""     # actor loaded when pre_train
    test_model: str = ""          # actor + critic loaded when if_test


@dataclass
class MeshConfig:
    """Device-mesh axes (the JAX package's MeshConfig): data = batch
    sharding over the process group, one rank a device (-1: the whole
    world; `core/mesh.py` holds any other value to the world size when the
    mesh is built), model = tensor parallelism, seq = the token stream's
    sharding. The port shards only `data`: model or seq above 1 is refused
    by name."""

    data: int = -1
    model: int = 1
    seq: int = 1

    def validate(self):
        if self.data != -1 and self.data < 1:
            raise ValueError(f"mesh.data {self.data}: -1 or a rank count")
        if self.model != 1 or self.seq != 1:
            raise NotImplementedError(
                f"mesh (data {self.data}, model {self.model}, seq "
                f"{self.seq}): the model and seq axes are not ported; the "
                "port takes model 1, seq 1")


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    sac: SACConfig = field(default_factory=SACConfig)
    env: EnvConfig = field(default_factory=EnvConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def validate(self) -> "Config":
        self.model.validate()
        self.sac.validate()
        self.env.validate()
        self.mesh.validate()
        return self

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Config":
        return _update_dataclass(cls(), data).validate()

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        return cls.from_dict(data)

    def to_dict(self) -> Dict[str, Any]:
        def listify(x):
            if isinstance(x, dict):
                return {k: listify(v) for k, v in x.items()}
            if isinstance(x, tuple):
                return list(x)  # safe_dump rejects tuples
            return x

        return listify(dataclasses.asdict(self))


def load_reference_yaml(path: str) -> Config:
    """A reference-format config.yaml (flat keys; the GoT-SAC section for
    the networks) translated into a `Config`, key for key as the JAX
    package's `load_reference_yaml` does, then validated. `VIS_SENSOR`
    (the reference's `fish_image`) lands in `env.vis_sensor`, which only
    the JAX package's ROS 2 adapter reads: the kinematic env ignores it,
    as in the JAX package."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)

    cfg = Config()
    algo = raw.get("GoT-SAC", {})
    m = cfg.model
    m.name = algo.get("name", m.name)
    m.actor_type = algo.get("actor_type", m.actor_type)
    m.critic_type = algo.get("critic_type", m.critic_type)
    m.block = algo.get("block", m.block)
    m.head = algo.get("head", m.head)
    m.latent_size = raw.get("LATENT_FEATURES_SIZE", m.latent_size)

    s = cfg.sac
    s.batch_size = raw.get("BATCH_SIZE", s.batch_size)
    s.lr_actor = raw.get("LR_A", s.lr_actor)
    s.lr_critic = raw.get("LR_C", s.lr_critic)
    s.lr_alpha = raw.get("LR_ALPHA", s.lr_alpha)
    s.gamma = raw.get("GAMMA", s.gamma)
    s.tau = raw.get("TAU", s.tau)
    s.policy_freq = raw.get("ACTOR_FREQ", s.policy_freq)
    s.buffer_size = raw.get("BUFFER_SIZE", s.buffer_size)
    s.alpha = raw.get("ALPHA", s.alpha)
    s.auto_tune_alpha = raw.get("AUTO_TUNE", s.auto_tune_alpha)

    e = cfg.env
    e.vis_sensor = raw.get("VIS_SENSOR", e.vis_sensor)
    e.max_steps = raw.get("MAX_STEPS", e.max_steps)
    e.max_episodes = raw.get("MAX_EPISODES", e.max_episodes)
    e.linear_cmd_scale = raw.get("L_SCALE", e.linear_cmd_scale)
    e.angular_cmd_scale = raw.get("A_SCALE", e.angular_cmd_scale)
    e.frame_stack = raw.get("FRAME_STACK", e.frame_stack)

    t = cfg.train
    t.seed = raw.get("SEED", t.seed)
    t.desc = str(raw.get("DESC", t.desc))
    t.plot_interval = raw.get("PLOT_INTERVAL", t.plot_interval)
    t.eval_threshold = raw.get("EVAL_THRESHOLD", t.eval_threshold)
    t.eval_epoch = raw.get("EVAL_EPOCH", t.eval_epoch)
    t.save_interval = raw.get("SAVE_INTERVAL", t.save_interval)
    t.save_threshold = raw.get("SAVE_THRESHOLD", t.save_threshold)
    t.reward_threshold = raw.get("REWARD_THRESHOLD", t.reward_threshold)
    t.save = raw.get("SAVE", t.save)
    t.pre_train = raw.get("PRE_TRAIN", t.pre_train)
    t.if_test = raw.get("IF_TEST", t.if_test)
    t.pre_buffer = raw.get("PRE_BUFFER", t.pre_buffer)
    t.human_intervention = raw.get("HUMAN_INTERVENTION", t.human_intervention)
    t.policy_attention_fix = raw.get("P_ATTENTION_FIX", t.policy_attention_fix)
    t.critic_attention_fix = raw.get("C_ATTENTION_FIX", t.critic_attention_fix)
    t.robot = raw.get("ROBOT", t.robot)
    return cfg.validate()
