"""The on-disk event record: the structured dtype of the `event_stream`
array in the CLI's npz output."""

import numpy as np

EVENT_DTYPE = np.dtype(
    [("timestamp", "<i8"), ("x", "<i2"), ("y", "<i2"), ("polarity", "i1")]
)
