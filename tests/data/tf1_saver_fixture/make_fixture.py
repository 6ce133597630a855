"""Write the committed TF1 ``Saver`` checkpoint of this directory and the
``.npz`` of its values (tests/test_torch_tf_import.py, ``chip_smoke.py``).

    python tests/data/tf1_saver_fixture/make_fixture.py

Needs TensorFlow (written with 2.21): a ``tf.compat.v1`` graph of one
variable of each numeric dtype the port's reader takes, named as the
reference's variables are (a conv kernel and bias, a BN's statistics, a
transposed conv's kernel), trained one Adam step so that the checkpoint
also holds the Adam slots, ``beta1_power``, ``beta2_power`` and
``global_step``.  The values come from numpy with seed 0.
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    import tensorflow as tf

    tf1 = tf.compat.v1
    rng = np.random.default_rng(0)
    values = {
        "conv3_0_1": rng.normal(size=(1, 1, 1, 4, 3)).astype(np.float32),
        "x_3_1/bias": rng.normal(size=(3,)).astype(np.float32),
        "batch_normalization/moving_mean": rng.normal(size=(3,)).astype(np.float64),
        "upx_4_0/kernel": rng.normal(size=(3, 3, 3, 2, 4)).astype(np.float16),
        "counts/int32": rng.integers(-2**31, 2**31, (2, 3), dtype=np.int32),
        "counts/uint8": rng.integers(0, 256, (5,), dtype=np.uint8),
        "counts/int16": rng.integers(-2**15, 2**15, (2, 2), dtype=np.int16),
        "counts/int8": rng.integers(-128, 128, (7,), dtype=np.int8),
        "counts/int64": rng.integers(-2**62, 2**62, (3,), dtype=np.int64),
        "flags": rng.integers(0, 2, (2, 3)).astype(bool),
        "gammax_1_3_sa": np.float32(rng.uniform(0.5, 1.5)),
    }
    graph = tf1.Graph()
    with graph.as_default():
        variables = {name: tf1.get_variable(name, initializer=tf1.constant(value))
                     for name, value in values.items()}
        step = tf1.train.get_or_create_global_step()
        loss = tf1.reduce_sum(tf1.square(variables["conv3_0_1"])) \
            + tf1.reduce_sum(variables["x_3_1/bias"])
        train = tf1.train.AdamOptimizer(1e-2).minimize(loss, global_step=step)
        saver = tf1.train.Saver(save_relative_paths=True)
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            sess.run(train)
            saver.save(sess, os.path.join(HERE, "model.ckpt"))
    reader = tf.train.load_checkpoint(HERE)
    np.savez(os.path.join(HERE, "values.npz"),
             **{name: reader.get_tensor(name) for name in reader.get_variable_to_shape_map()})


if __name__ == "__main__":
    main()
