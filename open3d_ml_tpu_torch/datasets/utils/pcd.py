"""A PCD point-cloud reader (ascii and binary data), numpy only.

Counterpart of ``open3d_ml_tpu/datasets/utils/pcd.py``, the same code.
"""

import numpy as np

_PCD_DTYPES = {
    ("F", 4): "f4", ("F", 8): "f8",
    ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4",
    ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4",
}


def read_pcd(path):
    """Read a .pcd file -> dict {field_name: np.ndarray}.

    COUNT>1 fields expand to name_0..name_{c-1}. Compressed PCDs are not
    supported.
    """
    with open(path, "rb") as f:
        fields, sizes, types, counts = [], [], [], []
        npoints = 0
        data_fmt = "ascii"
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, val = line.partition(" ")
            key = key.upper()
            if key == "FIELDS":
                fields = val.split()
            elif key == "SIZE":
                sizes = [int(x) for x in val.split()]
            elif key == "TYPE":
                types = val.split()
            elif key == "COUNT":
                counts = [int(x) for x in val.split()]
            elif key == "POINTS":
                npoints = int(val)
            elif key == "DATA":
                data_fmt = val.strip()
                break
        if not counts:
            counts = [1] * len(fields)

        names = []
        dtypes = []
        for fname, size, typ, cnt in zip(fields, sizes, types, counts):
            base = _PCD_DTYPES[(typ, size)]
            if cnt == 1:
                names.append(fname)
                dtypes.append((fname, base))
            else:
                for c in range(cnt):
                    names.append(f"{fname}_{c}")
                    dtypes.append((f"{fname}_{c}", base))
        dtype = np.dtype(dtypes)

        if data_fmt == "ascii":
            rows = np.loadtxt(f, max_rows=npoints, dtype=np.float64,
                              ndmin=2)
            rec = np.zeros(npoints, dtype)
            for i, nm in enumerate(names):
                rec[nm] = rows[:, i].astype(dtype[nm])
        elif data_fmt == "binary":
            rec = np.frombuffer(f.read(npoints * dtype.itemsize),
                                dtype=dtype, count=npoints)
        else:
            raise ValueError(f"Unsupported PCD data format: {data_fmt}")
        return {nm: np.ascontiguousarray(rec[nm]) for nm in names}
