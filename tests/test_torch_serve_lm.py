"""The port's LM serving entry point (``repro_torch.launch.serve_lm_cli``) on
the CPU: it serves ``mini`` and the two smoke configurations and returns
the reference ``serve``'s keys."""
import argparse

import pytest

from repro.launch.serve_lm_cli import serve as jax_serve
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve_lm_cli import main, serve
from repro_torch.launch.train import mini_config


def _args(arch, **kw):
    return argparse.Namespace(**{**dict(arch=arch, batch=2, prompt_len=9, gen=4, seed=0,
                                        device="cpu"), **kw})


def test_serve_returns_the_reference_keys(capsys):
    args = _args("mini")
    want = jax_serve(argparse.Namespace(**{k: v for k, v in vars(args).items()
                                           if k != "device"}))
    got = serve(args)
    assert set(got) == set(want)
    assert got["tokens"].shape == tuple(want["tokens"].shape) == (2, 4)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "gemma3-12b", "mini"])
def test_serve_decodes_tokens_in_the_vocabulary(arch, capsys):
    got = serve(_args(arch, gen=5))
    assert got["tokens"].shape == (2, 5)
    assert got["prefill_s"] > 0 and got["decode_tok_s"] > 0
    vocab = (mini_config() if arch == "mini" else get_smoke_config(arch)).vocab_size
    assert 0 <= int(got["tokens"].min()) and int(got["tokens"].max()) < vocab
    assert f"arch={arch}" in capsys.readouterr().out


def test_serve_is_deterministic_per_seed():
    a = serve(_args("gemma3-12b", seed=3))["tokens"]
    b = serve(_args("gemma3-12b", seed=3))["tokens"]
    assert (a == b).all()


def test_main_runs_on_the_cpu(capsys):
    main(["--arch", "rwkv6-1.6b", "--batch", "1", "--prompt-len", "5", "--gen", "3",
          "--device", "cpu"])
    assert "prefill:" in capsys.readouterr().out
