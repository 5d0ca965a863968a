import os

# The reference project's data directory (meta_data/novel_pose.pkl,
# mano/mano_rest.pkl), read where it sits under the root of this checkout.
REFERENCE_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "data")
