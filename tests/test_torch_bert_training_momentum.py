"""bench.py's bench_bert program at BertConfig.tiny(), B=4, S=64, dropout
0, under Momentum(0.9) with regularization=L2Decay(1e-4) and a
piecewise_decay learning rate: two steps against the JAX package on the
CPU, under the tolerances of tests/test_torch_bert_training_optim.py
(which holds the Lamb and AdamW configurations)."""

from test_torch_bert_training_optim import check_two_steps


def test_two_momentum_steps_with_l2_match_the_jax_package():
    check_two_steps("momentum_l2_piecewise")
