"""train_samples_per_s: training samples of the steps completed in the
window (each step's end a CUDA event on the device's clock), over the
window's seconds."""


def read(run):
    return run.steps * run.batch / run.window.seconds
