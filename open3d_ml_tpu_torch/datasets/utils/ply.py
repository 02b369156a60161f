"""PLY point clouds: read and write with numpy alone.

Copy of ``open3d_ml_tpu/datasets/utils/ply.py``: the reader parses the
``vertex`` element of ascii, binary_little_endian and binary_big_endian
files with any scalar properties; the writer writes named columns as
binary_little_endian.
"""

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path):
    """Read a .ply file -> dict {property_name: np.ndarray}.

    Only the 'vertex' element is parsed (point cloud usage).
    """
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype)])
        while True:
            line = f.readline().strip().decode("ascii", errors="replace")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("comment") or line.startswith("obj_info"):
                continue
            elif line.startswith("element"):
                _, name, count = line.split()
                elements.append((name, int(count), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(
                        (parts[-1], ("list", parts[2], parts[3])))
                else:
                    elements[-1][2].append((parts[-1], parts[1]))
            elif line == "end_header":
                break

        out = {}
        for name, count, props in elements:
            if any(isinstance(t, tuple) for _, t in props):
                # element with list property (e.g. faces): skip payload if
                # possible (only handled for ascii)
                if fmt == "ascii":
                    for _ in range(count):
                        f.readline()
                    continue
                if name != "vertex":
                    break  # cannot skip binary lists reliably; stop
            dtype = np.dtype([(p, _PLY_DTYPES[t]) for p, t in props])
            if fmt == "ascii":
                rows = np.loadtxt(f, max_rows=count, dtype=np.float64,
                                  ndmin=2)
                rec = np.zeros(count, dtype)
                for i, (p, t) in enumerate(props):
                    rec[p] = rows[:, i].astype(_PLY_DTYPES[t])
            elif fmt == "binary_little_endian":
                rec = np.frombuffer(f.read(count * dtype.itemsize),
                                    dtype=dtype, count=count)
            elif fmt == "binary_big_endian":
                bd = np.dtype([(p, ">" + _PLY_DTYPES[t]) for p, t in props])
                rec = np.frombuffer(f.read(count * bd.itemsize), dtype=bd,
                                    count=count)
            else:
                raise ValueError(f"Unsupported PLY format {fmt}")
            if name == "vertex":
                for p, _ in props:
                    out[p] = np.ascontiguousarray(rec[p])
        return out


def write_ply(path, arrays, names):
    """Write named float/int columns as a binary_little_endian PLY.

    Args:
        arrays: list of [N] or [N, k] arrays.
        names: flat list of property names (total of all columns).
    """
    cols = []
    for a in arrays:
        a = np.asarray(a)
        if a.ndim == 1:
            cols.append(a)
        else:
            cols.extend([a[:, i] for i in range(a.shape[1])])
    assert len(cols) == len(names)
    n = len(cols[0])

    def ply_type(dt):
        if dt.kind == "f":
            return "float" if dt.itemsize <= 4 else "double"
        if dt.kind in "iu":
            return {1: "uchar", 2: "ushort", 4: "int"}[min(dt.itemsize, 4)]
        raise ValueError(dt)

    dtype = np.dtype([(nm, c.dtype.newbyteorder("<"))
                      for nm, c in zip(names, cols)])
    rec = np.zeros(n, dtype)
    for nm, c in zip(names, cols):
        rec[nm] = c
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for nm, c in zip(names, cols):
            f.write(f"property {ply_type(c.dtype)} {nm}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())
