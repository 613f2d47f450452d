"""vgg11_bn of the port against the JAX package's module on the CPU: the
checks, sizes and tolerances of ``test_torch_zoo_models.py`` (a file of
its own so that loadfile places it on another worker: its 4096-wide
classifier reads the 7×7 pool's 25 088 values, 103 M weights in ``fc1``).
"""

from test_torch_zoo_models import (  # noqa: F401
    check_against_jax,
    check_flatten_order,
    check_round_trip,
    no_tf32,
)


def test_forwards_stats_and_gradients_match_jax():
    check_against_jax("vgg11_bn")


def test_weights_round_trip_through_the_jax_init_tree():
    check_round_trip("vgg11_bn")


def test_first_dense_reads_the_flatten_in_chw_order():
    check_flatten_order("vgg11_bn", 7, 512)
