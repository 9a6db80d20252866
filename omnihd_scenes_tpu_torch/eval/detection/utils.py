"""Label-space mapping for detection eval (reference
``newscenes_devkit/eval/detection/utils.py``): 12 raw OmniHD categories
collapse onto the 4 eval classes; anything else is dropped."""

from typing import List, Optional

DETECTION_MAPPING = {
    'suv': 'car',
    'van': 'car',
    'truck': 'large_vehicle',
    'rider': 'rider',
    'pedestrian': 'pedestrian',
    'car': 'car',
    'tricyclist': 'car',
    'light_truck': 'large_vehicle',
    'bus': 'large_vehicle',
    'engineering_vehicle': 'large_vehicle',
    'handcart': 'car',
    'trailer': 'large_vehicle',
}


def category_to_detection_name(category_name: str) -> Optional[str]:
    """Raw category -> detection class, or None if out of eval scope."""
    return DETECTION_MAPPING.get(category_name)


def detection_name_to_rel_attributes(detection_name: str) -> List[str]:
    """OmniHD classes carry no attributes; kept for API parity."""
    return []
