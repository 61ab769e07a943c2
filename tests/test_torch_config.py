"""The port's Config against the JAX package's: every key JAX's config
takes, the port takes with JAX's default (fault o: model.dropout,
train.data_dir, the mesh section and sac.critic_latent_reuse raised
KeyError in the port); what the port has not ported it refuses by name
(a model or seq mesh axis), never by a KeyError. sac.critic_latent_reuse
is ported (tests/test_torch_latent_reuse.py), and so is a data mesh axis
above 1 (tests/test_torch_mesh.py)."""

import dataclasses

import pytest

from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu_torch.config import Config

SECTIONS = ("model", "sac", "env", "mesh", "train")


def defaults(cfg):
    return {s: {f.name: getattr(getattr(cfg, s), f.name)
                for f in dataclasses.fields(getattr(cfg, s))}
            for s in SECTIONS}


def test_every_jax_key_is_a_port_key_with_jax_default():
    """Each key of each section of JAX's Config() is a key of the port's
    with the same default (the port's sections may hold more)."""
    jax_cfg, port = defaults(JaxConfig()), defaults(Config())
    assert set(f.name for f in dataclasses.fields(JaxConfig)) == \
        set(f.name for f in dataclasses.fields(Config)) == set(SECTIONS)
    for section, keys in jax_cfg.items():
        for key, value in keys.items():
            assert key in port[section], f"{section}.{key}"
            assert port[section][key] == value, f"{section}.{key}"


# fault o's keys, each with a value both packages accept
ACCEPTED = [{"model": {"dropout": 0.0}}, {"model": {"dropout": 0.1}},
            {"train": {"data_dir": "demos"}},
            {"mesh": {"data": -1, "model": 1, "seq": 1}},
            {"mesh": {"data": 1}}, {"mesh": {"data": 4}},
            {"sac": {"critic_latent_reuse": False}},
            {"sac": {"critic_latent_reuse": True}}]


@pytest.mark.parametrize("over", ACCEPTED, ids=lambda o: str(o))
def test_from_dict_takes_what_jax_takes(over):
    """Config.from_dict takes each key in both packages, and the section
    reads back the same."""
    port, ref = Config.from_dict(over), JaxConfig.from_dict(over)
    (section, keys), = over.items()
    for key, value in keys.items():
        assert getattr(getattr(port, section), key) == \
            getattr(getattr(ref, section), key) == value
    assert port.to_dict()[section] == {
        k: v for k, v in ref.to_dict()[section].items()
        if k in port.to_dict()[section]}


# what JAX takes and the port has not ported: refused by name
REFUSED = [({"mesh": {"model": 2}}, "mesh"),
           ({"mesh": {"seq": 2}}, "mesh")]


@pytest.mark.parametrize("over,name", REFUSED, ids=lambda o: str(o))
def test_unported_values_are_refused_by_name(over, name):
    JaxConfig.from_dict(over)
    with pytest.raises(NotImplementedError, match=name):
        Config.from_dict(over)


def test_unknown_keys_still_raise():
    with pytest.raises(KeyError, match="mesh.shards"):
        Config.from_dict({"mesh": {"shards": 2}})
