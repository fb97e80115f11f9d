"""The clip file's protobuf messages (counterpart of
``dm_control_tpu/locomotion/mocap/proto/mocap_pb2.py``).

The same three messages with the same field numbers as the JAX package's
``proto/mocap.proto``, so a bank written by either package reads in the
other.  The file is registered under its own name and package
(``dm_control_torch/mocap.proto``, ``dm_control_torch.mocap``): protobuf's
default pool refuses a second file of the JAX copy's name with other
contents, and both modules must import in one process.  The descriptor is
built here with protobuf's own API, not from generated bytes:

    message TimestepData {
      repeated double qpos = 1; repeated double qvel = 2;
    }
    message Trajectory {
      string identifier = 1; double dt = 2;
      repeated TimestepData timesteps = 3; map<string, string> metadata = 4;
    }
    message TrajectoryBank { repeated Trajectory trajectories = 1; }

Import it only where a bank is read or written: ``protobuf`` is needed for
nothing else.
"""

from google.protobuf import descriptor_pb2 as _descriptor_pb2
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf.internal import builder as _builder

FILE_NAME = "dm_control_torch/mocap.proto"
PACKAGE = "dm_control_torch.mocap"

_F = _descriptor_pb2.FieldDescriptorProto


def _field(message, name, number, kind, label=_F.LABEL_OPTIONAL,
           type_name=None):
    field = message.field.add(name=name, number=number, type=kind,
                              label=label)
    if type_name:
        field.type_name = type_name
    return field


def _file_descriptor():
    fdp = _descriptor_pb2.FileDescriptorProto(name=FILE_NAME,
                                              package=PACKAGE,
                                              syntax="proto3")
    timestep = fdp.message_type.add(name="TimestepData")
    _field(timestep, "qpos", 1, _F.TYPE_DOUBLE, _F.LABEL_REPEATED)
    _field(timestep, "qvel", 2, _F.TYPE_DOUBLE, _F.LABEL_REPEATED)
    trajectory = fdp.message_type.add(name="Trajectory")
    _field(trajectory, "identifier", 1, _F.TYPE_STRING)
    _field(trajectory, "dt", 2, _F.TYPE_DOUBLE)
    _field(trajectory, "timesteps", 3, _F.TYPE_MESSAGE, _F.LABEL_REPEATED,
           f".{PACKAGE}.TimestepData")
    _field(trajectory, "metadata", 4, _F.TYPE_MESSAGE, _F.LABEL_REPEATED,
           f".{PACKAGE}.Trajectory.MetadataEntry")
    entry = trajectory.nested_type.add(name="MetadataEntry")
    entry.options.map_entry = True
    _field(entry, "key", 1, _F.TYPE_STRING)
    _field(entry, "value", 2, _F.TYPE_STRING)
    bank = fdp.message_type.add(name="TrajectoryBank")
    _field(bank, "trajectories", 1, _F.TYPE_MESSAGE, _F.LABEL_REPEATED,
           f".{PACKAGE}.Trajectory")
    return fdp


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(
    _file_descriptor().SerializeToString())

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, __name__, globals())
